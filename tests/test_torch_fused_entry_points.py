"""The port's fused entry points — ``tail_loss_fused``, ``unet_fused``,
``unet_fused_fwdonly``, ``unet_fused_fwdbwd``, ``gsr_step_loss_fused`` and
``step_value_and_grad_fused`` — against the JAX functions of the same
names (Pallas interpret mode on the CPU) and against autograd over the
port's plain oracle, at the tiny config (20 -> 32 nodes, ks=(0.9, 0.7)),
for one model (2-D inputs) and for a fold batch (F = 2).

Tolerances: the JAX kernels' products are compensated bf16x3, the port's
IEEE fp32, so values agree to ~1e-5 relative; gradients are compared after
scaling by their largest entry, at 3e-4 (the JAX package's own tolerance
for its hand-written adjoints against XLA autodiff). Against the port's
own oracle (the same fp32 arithmetic in another order) gradients agree to
1e-5 of their largest entry.

JAX and the JAX package load inside the tests that compare with them, so
the card test collects where they are not installed (``pytest
--noconftest -m cuda``): it takes its weights from the port's own
``GSRNet`` init.
"""

import importlib

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.core.normalize import normalize_adj_np
from fcsr_tpu_torch.iox.weights import (flax_to_state, leaf_names,
                                        leaf_tensors_to_state,
                                        state_to_leaf_tensors, state_to_leaves)
from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.models import (GSRNet, gsr_step_loss_fused,
                                   step_loss_pure, step_value_and_grad_fused,
                                   tail_loss_fused, tail_loss_reference,
                                   unet_forward_rankselect, unet_fused,
                                   unet_fused_fwdbwd, unet_fused_fwdonly)
from fcsr_tpu_torch.train import GSRTrainConfig

CFG = GSRTrainConfig(lr_dim=20, hr_dim=32, hidden_dim=32, ks=(0.9, 0.7))
N, M, KS = CFG.lr_dim, CFG.hr_dim, CFG.ks
NET_NAMES = leaf_names(len(KS), tail=False)
TAIL = ("layer.weights", "gc1.weight", "gc2.weight")
# the port's entry point and the name of the JAX package's
UNETS = {"unet_fused": (unet_fused, "unet_fused"),
         "unet_fused_fwdonly": (unet_fused_fwdonly, "unet_fused_fwdonly"),
         "unet_fused_fwdbwd": (unet_fused_fwdbwd, "unet_fused_fwdbwd")}


def _jax():
    """(jax, jax.numpy), imported by the tests that compare with JAX."""
    return importlib.import_module("jax"), importlib.import_module("jax.numpy")


def _jfs():
    return importlib.import_module("fcsr_tpu.models.fused_step")


def _jft():
    return importlib.import_module("fcsr_tpu.models.fused_tail")


def _flax(seed):
    """The JAX package's GSR-Net init at the test's config."""
    jax, _ = _jax()
    jtrain = importlib.import_module("fcsr_tpu.train")
    cfg = jtrain.GSRTrainConfig(lr_dim=N, hr_dim=M, hidden_dim=M, ks=KS)
    _, params, _, _ = jtrain.init_gsr(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def random_symmetric(rng, n):
    """``tests/conftest.py::random_symmetric`` at density 1 (the same draws
    and bits): conftest imports JAX, the card's machine has none."""
    m = np.triu(rng.random((n, n)), k=1)
    return (m + m.T).astype(np.float32)


def _data(rng, n_folds):
    lrs = [random_symmetric(rng, N) for _ in range(n_folds)]
    u_lr = np.stack([np.linalg.eigh(normalize_adj_np(a))[1]
                     for a in lrs]).astype(np.float32)
    u_hr = rng.normal(size=(n_folds, M, N)).astype(np.float32)
    hr = np.stack([random_symmetric(rng, M) for _ in range(n_folds)])
    return u_lr, u_hr, hr


def _stack_states(flaxes):
    states = [flax_to_state(p) for p in flaxes]
    return {k: torch.from_numpy(np.stack([s[k] for s in states]))
            for k in states[0]}


def _leaves(flaxes, batched):
    """The port's leaf tensors (requiring grad) for the given flax trees:
    (F, ...) when ``batched``, else the first model's 2-D leaves."""
    leaves = state_to_leaf_tensors(_stack_states(flaxes))
    return {k: (t if batched else t[0]).clone().requires_grad_()
            for k, t in leaves.items()}


def _pick(x, batched):
    return torch.from_numpy(x if batched else x[0])


def _close_scaled(got, want, atol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


def _check_state_grads(leaves, j_grads, batched, atol=3e-4):
    """The leaves' ``.grad`` against JAX gradient trees (one per fold)."""
    jax, _ = _jax()
    got = leaf_tensors_to_state({k: t.grad for k, t in leaves.items()})
    for f, tree in enumerate(j_grads):
        want = flax_to_state(jax.tree_util.tree_map(np.asarray, tree))
        for k, w in want.items():
            g = got[k][f] if batched else got[k]
            _close_scaled(g.numpy(), w, atol, name=f"{k} fold {f}")


def _folds(batched):
    return 2 if batched else 1


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "F2"])
def test_tail_loss_fused_matches_jax(rng, batched):
    """#4: value and the four gradients under a cotangent of 2.5."""
    jax, jnp = _jax()
    F = _folds(batched)
    w_gsr = rng.normal(size=(F, M, N)).astype(np.float32)
    w1, w2 = (rng.uniform(-0.3, 0.3, (F, M, M)).astype(np.float32)
              for _ in range(2))
    f = rng.normal(0, 0.3, (F, N, M)).astype(np.float32)
    data = _data(rng, F)
    diff = [_pick(a, batched).requires_grad_() for a in (w_gsr, w1, w2, f)]
    loss = tail_loss_fused(*diff, *[_pick(a, batched) for a in data],
                           device="cpu")
    assert tuple(loss.shape) == ((F,) if batched else ())
    (2.5 * loss).sum().backward()
    for j in range(F):
        args = [jnp.asarray(a[j]) for a in (w_gsr, w1, w2, f, *data)]
        jl, jg = jax.value_and_grad(
            lambda *a: 2.5 * _jft().tail_loss_fused(*a, interpret=True),
            argnums=(0, 1, 2, 3))(*args)
        got = loss[j] if batched else loss
        np.testing.assert_allclose(2.5 * float(got.detach()), float(jl),
                                   rtol=1e-5)
        for name, t, w in zip(("w_gsr", "w1", "w2", "f"), diff, jg):
            _close_scaled((t.grad[j] if batched else t.grad).numpy(), w,
                          3e-4, name)


def test_tail_loss_fused_backward_is_autograd_of_the_plain_tail(rng):
    F = 2
    args = [torch.from_numpy(a) for a in (
        rng.normal(size=(F, M, N)).astype(np.float32),
        rng.uniform(-0.3, 0.3, (F, M, M)).astype(np.float32),
        rng.uniform(-0.3, 0.3, (F, M, M)).astype(np.float32),
        rng.normal(0, 0.3, (F, N, M)).astype(np.float32), *_data(rng, F))]
    _, jnp = _jax()
    want_loss, want_recon, want = tail_loss_reference(*args)
    jl, jr, _ = _jft().tail_loss_reference(*[jnp.asarray(a[0].numpy())
                                             for a in args])
    np.testing.assert_allclose(float(want_loss[0]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(want_recon[0]), float(jr), rtol=1e-5)
    diff = [a.clone().requires_grad_() for a in args[:4]]
    ct = torch.tensor([2.5, -0.5])
    loss = tail_loss_fused(*diff, *args[4:], device="cpu")
    torch.testing.assert_close(loss.detach(), want_loss, rtol=1e-6, atol=0)
    (ct * loss).sum().backward()
    for name, t, w in zip(("w_gsr", "w1", "w2", "f"), diff, want):
        _close_scaled(t.grad.numpy(), (ct[:, None, None] * w).numpy(), 1e-5,
                      name)
    # the data arguments carry no gradient
    data = [a.clone().requires_grad_() for a in args[4:]]
    out = tail_loss_fused(*[a.detach() for a in diff], *data, device="cpu")
    assert torch.autograd.grad(out.sum(), data, allow_unused=True) == (
        None, None, None)


@pytest.mark.parametrize("name", sorted(UNETS))
@pytest.mark.parametrize("batched", [False, True], ids=["2d", "F2"])
def test_unet_entry_points_match_jax(rng, name, batched):
    """#5, #6, #7: (net, start) and every gradient under random cotangents
    on both outputs, against the JAX function in interpret mode."""
    jax, jnp = _jax()
    fn, j_name = UNETS[name]
    j_fn = getattr(_jfs(), j_name)
    F = _folds(batched)
    flaxes = [_flax(seed) for seed in range(F)]
    leaves = _leaves(flaxes, batched)
    ct_net = rng.normal(size=(F, N, M)).astype(np.float32)
    ct_start = rng.normal(size=(F, N, M)).astype(np.float32)
    net_params = {k: leaves[k] for k in NET_NAMES}
    net, start = fn(net_params, KS, N, M, device="cpu")
    assert tuple(net.shape) == ((F, N, M) if batched else (N, M))
    ((net * _pick(ct_net, batched)).sum()
     + (start * _pick(ct_start, batched)).sum()).backward()
    j_grads = []
    for j in range(F):
        def j_loss(p):
            n, s = j_fn(p, KS, N, M, interpret=True)
            return jnp.sum(n * ct_net[j]) + jnp.sum(s * ct_start[j]), (n, s)
        (_, (jn, js)), g = jax.value_and_grad(j_loss, has_aux=True)(
            flaxes[j]["params"]["net"])
        np.testing.assert_allclose(
            (net[j] if batched else net).detach().numpy(), np.asarray(jn),
            atol=1e-5)
        np.testing.assert_allclose(
            (start[j] if batched else start).detach().numpy(),
            np.asarray(js), atol=1e-5)
        tree = jax.tree_util.tree_map(jnp.zeros_like, flaxes[j])
        tree["params"]["net"] = g
        j_grads.append(tree)
    for k in TAIL:
        leaves[k].grad = torch.zeros_like(leaves[k])
    _check_state_grads(leaves, j_grads, batched)


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_entry_points_backward_is_autograd_of_the_oracle(rng, name):
    fn, _ = UNETS[name]
    flaxes = [_flax(seed) for seed in (3, 4)]
    ct = [torch.from_numpy(rng.normal(size=(2, N, M)).astype(np.float32))
          for _ in range(2)]
    grads = []
    for f in (fn, lambda p, ks, n, m, device: unet_forward_rankselect(
            p, ks, n)):
        leaves = _leaves(flaxes, True)
        net, start = f({k: leaves[k] for k in NET_NAMES}, KS, N, M,
                       device="cpu")
        ((net * ct[0]).sum() + (start * ct[1]).sum()).backward()
        grads.append((net.detach(), {k: leaves[k].grad for k in NET_NAMES}))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-6, rtol=0)
    for k in NET_NAMES:
        _close_scaled(grads[0][1][k].numpy(), grads[1][1][k].numpy(), 1e-5, k)


def test_oracle_unet_matches_jax_rankselect_and_the_module():
    flax = _flax(5)
    leaves = _leaves([flax], False)
    with torch.no_grad():
        net, start = unet_forward_rankselect(leaves, KS, N)
    jn, js = _jfs().unet_forward_rankselect(flax["params"]["net"], KS, N)
    np.testing.assert_allclose(net.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(start.numpy(), np.asarray(js), atol=1e-5)
    model = GSRNet(KS, N, M, M, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in flax_to_state(flax).items()})
    with torch.no_grad():
        m_net, m_start = model.net(torch.eye(N), torch.eye(N))
    torch.testing.assert_close(net, m_net, atol=1e-6, rtol=0)
    torch.testing.assert_close(start, m_start, atol=1e-6, rtol=0)


def _tied_leaves():
    """Two folds whose level-0 pooling scores tie exactly: fold 0 has a
    zero pooling weight (every score equal), fold 1 three equal rows."""
    flaxes = [_flax(seed) for seed in (6, 7)]
    state = _stack_states(flaxes)
    state["net.pools.0.proj.weight"][0] = 0.0
    w = state["net.start_gcn.proj.weight"]          # (F, out, in)
    w[1, :, 5] = w[1, :, 2]
    w[1, :, 9] = w[1, :, 2]
    leaves = state_to_leaf_tensors(state)
    return {k: t.clone().requires_grad_() for k, t in leaves.items()}


def test_unet_fwdonly_differentiates_the_rows_the_forward_kept(rng):
    """At an exact tie the selection is the lower index on both sides, and
    the backward differentiates the selection the forward made: with the
    forward's rows swapped for other rows of equal score the gradient
    follows the swap."""
    from fcsr_tpu_torch.models.fused_step import pool_sizes, unet_forward
    leaves = _tied_leaves()
    net_params = {k: leaves[k] for k in NET_NAMES}
    sizes = pool_sizes(N, KS)
    with torch.no_grad():
        _, _, res = unet_forward(KERNEL_OPS, net_params, net_params, sizes)
    idx0 = res["idx"][0]
    np.testing.assert_array_equal(idx0[0].numpy(), np.arange(sizes[0]))
    pos = {int(v): i for i, v in enumerate(idx0[1].tolist())}
    assert pos[2] + 1 == pos[5] and pos[5] + 1 == pos[9]   # tie: index order
    ct = torch.from_numpy(rng.normal(size=(2, N, M)).astype(np.float32))
    net, start = unet_fused_fwdonly(net_params, KS, N, M, device="cpu")
    (net * ct).sum().backward()
    got = {k: leaves[k].grad.clone() for k in NET_NAMES}
    fresh = {k: leaves[k].detach().clone().requires_grad_()
             for k in NET_NAMES}
    n2, _ = unet_forward_rankselect(fresh, KS, N)
    (n2 * ct).sum().backward()
    torch.testing.assert_close(net.detach(), n2.detach(), atol=1e-6, rtol=0)
    for k in NET_NAMES:
        _close_scaled(got[k].numpy(), fresh[k].grad.numpy(), 1e-5, k)
    # the oracle on forced rows: the kept rows are what is differentiated
    forced = [t.clone() for t in res["idx"]]
    forced[0][0] = torch.arange(N - sizes[0], N, dtype=torch.int32)
    alt = {k: leaves[k].detach().clone().requires_grad_()
           for k in NET_NAMES}
    n3, _ = unet_forward_rankselect(alt, KS, N, idx=forced)
    (n3 * ct).sum().backward()
    assert not torch.allclose(alt["w:down_gcns_0"].grad[0],
                              fresh["w:down_gcns_0"].grad[0])
    torch.testing.assert_close(alt["w:down_gcns_0"].grad[1],
                               fresh["w:down_gcns_0"].grad[1])


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "F2"])
def test_gsr_step_loss_fused_matches_jax(rng, batched):
    """#8: loss, recon and all 34 gradients under a cotangent of 2.5;
    recon carries no gradient."""
    jax, jnp = _jax()
    F = _folds(batched)
    flaxes = [_flax(seed) for seed in range(F)]
    leaves = _leaves(flaxes, batched)
    data = _data(rng, F)
    loss, recon = gsr_step_loss_fused(
        {k: leaves[k] for k in NET_NAMES}, *[leaves[k] for k in TAIL],
        *[_pick(a, batched) for a in data], KS, N, M, CFG.lmbda,
        device="cpu")
    assert loss.requires_grad and not recon.requires_grad
    assert tuple(loss.shape) == tuple(recon.shape) == ((F,) if batched
                                                       else ())
    (2.5 * loss).sum().backward()
    j_grads = []
    for j in range(F):
        def j_loss(p):
            pp = p["params"]
            l, r = _jfs().gsr_step_loss_fused(
                pp["net"], pp["layer"]["weights"], pp["gc1"]["weight"],
                pp["gc2"]["weight"], *[jnp.asarray(a[j]) for a in data], KS,
                N, M, CFG.lmbda, interpret=True)
            return 2.5 * l, (l, r)
        (_, (jl, jr)), g = jax.value_and_grad(j_loss, has_aux=True)(
            flaxes[j])
        np.testing.assert_allclose(
            float((loss[j] if batched else loss).detach()), float(jl),
            rtol=1e-5)
        np.testing.assert_allclose(
            float(recon[j] if batched else recon), float(jr), rtol=1e-5)
        j_grads.append(g)
    _check_state_grads(leaves, j_grads, batched)


def test_gsr_step_loss_fused_backward_is_autograd_of_the_oracle(rng):
    flaxes = [_flax(seed) for seed in (8, 9)]
    u_lr, u_hr, hr = (torch.from_numpy(a) for a in _data(rng, 2))
    ct = torch.tensor([2.5, 0.25])
    want = _leaves(flaxes, True)
    w_loss, w_recon = step_loss_pure(want, None, hr, u_lr, u_hr, KS, N,
                                     CFG.lmbda)
    (ct * w_loss).sum().backward()
    got = _leaves(flaxes, True)
    loss, recon = gsr_step_loss_fused(
        {k: got[k] for k in NET_NAMES}, *[got[k] for k in TAIL], u_lr, u_hr,
        hr, KS, N, M, CFG.lmbda, device="cpu")
    # a recon-weighted objective sees recon as a constant
    (ct * loss + 7.0 * recon).sum().backward()
    torch.testing.assert_close(loss.detach(), w_loss.detach(), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(recon, w_recon.detach(), rtol=1e-6, atol=0)
    for k in got:
        _close_scaled(got[k].grad.numpy(), want[k].grad.numpy(), 1e-5, k)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "F2"])
def test_step_value_and_grad_fused_matches_jax(rng, batched):
    """#10: (loss, recon, grads) over a state_dict, grads under its names
    and shapes."""
    jax, jnp = _jax()
    F = _folds(batched)
    flaxes = [_flax(seed) for seed in range(F)]
    state = _stack_states(flaxes)
    if not batched:
        state = {k: t[0] for k, t in state.items()}
    data = _data(rng, F)
    loss, recon, grads = step_value_and_grad_fused(
        state, *[_pick(a, batched) for a in data], KS, N, M, M, CFG.lmbda,
        device="cpu")
    assert sorted(grads) == sorted(state)
    for j in range(F):
        jl, jr, jg = _jfs().step_value_and_grad_fused(
            flaxes[j], *[jnp.asarray(a[j]) for a in data], KS, N, M, M,
            CFG.lmbda, interpret=True)
        np.testing.assert_allclose(
            float((loss[j] if batched else loss).detach()), float(jl),
            rtol=1e-5)
        np.testing.assert_allclose(
            float(recon[j] if batched else recon), float(jr), rtol=1e-5)
        want = flax_to_state(jax.tree_util.tree_map(np.asarray, jg))
        for k, w in want.items():
            g = grads[k][j] if batched else grads[k]
            assert g.shape == state[k].shape[1 if batched else 0:]
            _close_scaled(g.numpy(), w, 3e-4, k)
    with pytest.raises(ValueError, match="hidden_dim"):
        step_value_and_grad_fused(state, *[_pick(a, batched) for a in data],
                                  KS, N, M, M + 1, CFG.lmbda, device="cpu")


def test_leaf_tensor_mapping_round_trips_and_matches_numpy_leaves():
    flax = _flax(2)
    state = {k: torch.from_numpy(v) for k, v in flax_to_state(flax).items()}
    leaves = state_to_leaf_tensors(state)
    assert list(leaves) == leaf_names(len(KS))
    for t, a in zip(leaves.values(), state_to_leaves(flax_to_state(flax))):
        np.testing.assert_array_equal(t.numpy(), a)
    back = leaf_tensors_to_state(leaves)
    assert sorted(back) == sorted(state)
    for k in state:
        assert torch.equal(back[k], state[k])


def test_loss_terms_plain_orders_the_sum_as_adam_masked(rng):
    """The loss scalars the spectral term's ``l1_term`` writes (no launch of
    their own): the step's in ``adam_masked``'s order, the tail's without
    the L1 term; the spectral term is the one the launch computes."""
    vals = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(5, 4, 3)).astype(np.float32))
    b = torch.zeros(5, 4, 3)
    loss, recon, tail = (torch.empty(5) for _ in range(3))
    PLAIN_OPS.l1_term(a, b, vals, 2, 1.0, 1.0, False, loss=loss, recon=recon)
    KERNEL_OPS.l1_term(a, b, vals, 2, 1.0, 1.0, False, loss=tail,
                       with_l1=False)
    z = torch.zeros(5, 4)
    ones = torch.ones(5, 3)
    _, _, _, a_loss, a_recon = PLAIN_OPS.adam_masked(z, z, z, z, ones, vals,
                                                     1e-3, 0.9, 0.999, 1e-8)
    assert torch.equal(loss, a_loss) and torch.equal(recon, a_recon)
    assert torch.equal(tail, vals[:, 1] + vals[:, 2])


def test_entry_points_check_device_shapes_and_names(rng):
    leaves = _leaves([_flax(0)], False)
    net_params = {k: leaves[k] for k in NET_NAMES}
    u_lr, u_hr, hr = (_pick(a, False) for a in _data(rng, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            unet_fused_fwdbwd(net_params, KS, N, M)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tail_loss_fused(*[leaves[k] for k in TAIL], hr[:N], u_lr, u_hr,
                            hr)
    with pytest.raises(KeyError, match="w:pools_1"):
        unet_fused_fwdonly({k: v for k, v in net_params.items()
                            if k != "w:pools_1"}, KS, N, M, device="cpu")
    with pytest.raises(ValueError, match="w:start_gcn"):
        unet_fused(net_params, KS, N + 1, M, device="cpu")
    with pytest.raises(ValueError, match="u_hr"):
        gsr_step_loss_fused(net_params, *[leaves[k] for k in TAIL], u_lr,
                            u_hr[:, :-1], hr, KS, N, M, CFG.lmbda,
                            device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


def _port_leaves(seeds):
    """Leaf tensors (F, ...) of the port's own GSRNet inits, one per seed."""
    states = [GSRNet(KS, N, M, M, device="cpu", seed=s).state_dict()
              for s in seeds]
    return state_to_leaf_tensors({k: torch.stack([st[k] for st in states])
                                  for k in states[0]})


@pytest.mark.cuda
def test_entry_points_match_the_oracle_on_card(cuda_device):
    rng = np.random.default_rng(42)
    u_lr, u_hr, hr = (torch.from_numpy(a).to(cuda_device)
                      for a in _data(rng, 2))
    grads = []
    for fused in (True, False):
        leaves = {k: t.detach().to(cuda_device).requires_grad_()
                  for k, t in _port_leaves((0, 1)).items()}
        if fused:
            loss, _ = gsr_step_loss_fused(
                {k: leaves[k] for k in NET_NAMES},
                *[leaves[k] for k in TAIL], u_lr, u_hr, hr, KS, N, M,
                CFG.lmbda)
        else:
            loss, _ = step_loss_pure(leaves, None, hr, u_lr, u_hr, KS, N,
                                     CFG.lmbda)
        loss.sum().backward()
        grads.append({k: t.grad.cpu() for k, t in leaves.items()})
    for k in grads[0]:
        _close_scaled(grads[0][k].numpy(), grads[1][k].numpy(), 1e-4, k)
