"""Device-mesh data parallelism over the subject (batch) axis. Counterpart
of ``fcsr_tpu/parallel/mesh.py``.

A ``BatchMesh`` is an ordered tuple of placements along one ``('batch',)``
axis: ``batch_mesh`` takes distinct cards (by default every local one),
``virtual_batch_mesh`` puts several shards on one device, as the JAX
package's tests split the host CPU into 8 devices. ``shard_batch`` splits a
leading axis over the placements.

The data-parallel steps keep a replica of the model on every placement
(the caller's module on the first). Each shard computes, on its own
placement and in its own thread, the sum of its samples' losses divided by
the global batch; the replicas' gradients are summed in mesh order onto
the first placement (and, under a process group, ``all_reduce``d across
the processes), the caller's optimizer steps there, and the parameters
and buffers are copied back to the other replicas. The production
multi-device path is not these steps but fold sharding
(``GSRFoldRunner(mesh=)``, ``train_gat_folds_parallel(mesh=)``), which
needs no collective.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fcsr_tpu_torch.core.normalize import unpad
from fcsr_tpu_torch.models.mlp import sharded_batch
from fcsr_tpu_torch.parallel.distributed import group_rank, group_size
from fcsr_tpu_torch.train.losses import gsr_composite_loss
from fcsr_tpu_torch.utils.device import on_device, resolve_device

__all__ = ["BatchMesh", "batch_mesh", "virtual_batch_mesh", "shard_batch",
           "make_sharded_batch_step", "make_sharded_generic_step"]


class BatchMesh:
    """A 1-D ``('batch',)`` mesh: the placement of each shard, in order."""

    axis_names = ("batch",)

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            resolve_device(d)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"BatchMesh({[str(d) for d in self.devices]})"


def batch_mesh(devices: Optional[Sequence] = None) -> BatchMesh:
    """1-D mesh over distinct devices: the given ones, or every local CUDA
    device (raises without a card)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    if len(set(devices)) != len(devices):
        raise ValueError(f"batch_mesh takes distinct devices, got "
                         f"{[str(d) for d in devices]}; "
                         "virtual_batch_mesh places several shards on one")
    return BatchMesh(devices)


def virtual_batch_mesh(n: int, device="cuda") -> BatchMesh:
    """A mesh of ``n`` shards all placed on one device: the multi-shard
    code path on one card or on the CPU."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return BatchMesh([_indexed(device)] * n)


def _indexed(device) -> torch.device:
    """CUDA devices with their index (``cuda`` -> ``cuda:<current>``), so
    placements compare equal to tensors' devices."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        resolve_device(device)
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _split(mesh: BatchMesh, a) -> tuple:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis of {n} does not divide over a "
                         f"mesh of {mesh.size}")
    per = n // mesh.size
    return tuple(t[i * per:(i + 1) * per].to(d).contiguous()
                 for i, d in enumerate(mesh.devices))


def shard_batch(mesh: BatchMesh, *arrays):
    """Split each array's leading (batch) axis into ``mesh.size`` equal
    contiguous shards, shard i on placement i; refuses an axis that does
    not divide. Returns, per array, the tuple of its shards."""
    out = tuple(_split(mesh, a) for a in arrays)
    return out if len(out) > 1 else out[0]


def _shards(mesh: BatchMesh, arrays):
    """Pre-sharded tuples pass through; anything else is sharded."""
    return tuple(a if isinstance(a, (tuple, list)) and len(a) == mesh.size
                 and all(isinstance(s, torch.Tensor) for s in a)
                 else _split(mesh, a) for a in arrays)


def _run_shards(mesh: BatchMesh, fn: Callable[[int], object],
                barrier: Optional[threading.Barrier] = None) -> List:
    """``fn(i)`` for every shard, each in a thread of its own with its
    placement as the current device; results in mesh order. The first
    failure is raised (after aborting ``barrier``, so no shard waits on
    it)."""
    results: List = [None] * mesh.size
    errors: List = []

    def work(i):
        try:
            with on_device(mesh.devices[i]):
                results[i] = fn(i)
        except BaseException as e:          # re-raised on the caller
            errors.append((i, e))
            if barrier is not None:
                barrier.abort()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        errors.sort(key=lambda e: isinstance(e[1],
                                             threading.BrokenBarrierError))
        raise errors[0][1]
    return results


def _group_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the process group (differentiable); ``t`` itself
    without one."""
    if not dist.is_initialized():
        return t
    import torch.distributed.nn.functional as dist_nn
    return dist_nn.all_reduce(t)


class _Replicas:
    """The caller's module on the mesh's first placement and a copy of it on
    each other; ``sync`` copies its parameters and buffers to the copies."""

    def __init__(self, model: torch.nn.Module, mesh: BatchMesh):
        first = mesh.devices[0]
        where = {p.device for p in model.parameters()}
        if where != {first}:
            raise ValueError(f"the model's parameters lie on {where}; the "
                             f"mesh's first placement is {first}")
        self.mesh = mesh
        # the copies share the caller's generators (the shards' dropout
        # draws come from the first replica's, ``_Shard.uniform``)
        shared = {id(v): v for m in model.modules()
                  for v in vars(m).values() if isinstance(v, torch.Generator)}
        self.modules = [model] + [copy.deepcopy(model, dict(shared)).to(d)
                                  for d in mesh.devices[1:]]

    @torch.no_grad()
    def sync(self):
        src = self.modules[0]
        for r in self.modules[1:]:
            for a, b in zip(r.parameters(), src.parameters()):
                a.copy_(b)
            for a, b in zip(r.buffers(), src.buffers()):
                a.copy_(b)

    def reduce_grads(self):
        """Every replica's gradients summed in mesh order onto the first
        replica's ``.grad`` (then over the process group)."""
        params = [list(r.parameters()) for r in self.modules]
        for k, p in enumerate(params[0]):
            g = p.grad
            for rep in params[1:]:
                gr = rep[k].grad
                if gr is not None:
                    g = gr.to(p.device) if g is None else g + gr.to(p.device)
            if g is not None and dist.is_initialized():
                dist.all_reduce(g)
            p.grad = g
        for rep in params[1:]:
            for q in rep:
                q.grad = None

    def zero_grad(self):
        for r in self.modules:
            r.zero_grad(set_to_none=True)


def _batch_total(shards) -> int:
    """Samples in the whole batch: this process's, times the process
    group's size (every process holds as many)."""
    return sum(s.shape[0] for s in shards) * group_size()


def make_sharded_batch_step(model, optimizer: torch.optim.Optimizer,
                            mesh: BatchMesh, lmbda: float = 16.0,
                            padding: int = 0):
    """Data-parallel GSR-Net step: ``step(lr_b, hr_b, u_lr_b, u_hr_b) ->
    (loss, err)``, the batch means of the per-subject composite loss and
    reconstruction error (0-d tensors on the first placement). Each
    argument is a (B, ...) array, sharded over the mesh, or the tuple
    ``shard_batch`` made. The gradient is that of the whole batch's mean
    loss; ``optimizer`` (over ``model``'s parameters, on the first
    placement) updates ``model`` in place, and the replicas follow."""
    reps = _Replicas(model, mesh)

    def step(lr_b, hr_b, u_lr_b, u_hr_b):
        lr_s, hr_s, ul_s, uh_s = _shards(mesh, (lr_b, hr_b, u_lr_b, u_hr_b))
        total = _batch_total(lr_s)

        def shard(i):
            m = reps.modules[i]
            loss, err = 0.0, 0.0
            for j in range(lr_s[i].shape[0]):
                pred, net_outs, start_outs, _ = m(lr_s[i][j],
                                                  u_lr=ul_s[i][j])
                lj, ej = gsr_composite_loss(
                    unpad(pred, padding), net_outs, start_outs,
                    m.layer.weights, uh_s[i][j], hr_s[i][j], lmbda)
                loss, err = loss + lj, err + ej
            return loss / total, err.detach() / total

        return _update(reps, optimizer, _run_shards(mesh, shard))

    return step


def _update(reps: _Replicas, optimizer, outs):
    """Backward through every shard's loss, the mesh-order gradient sum,
    the optimizer step and the replicas' sync; returns the whole batch's
    loss (and the other outputs) summed on the first placement."""
    reps.zero_grad()
    torch.autograd.backward([o[0] for o in outs])
    reps.reduce_grads()
    optimizer.step()
    reps.sync()
    dev0 = reps.mesh.devices[0]
    sums = []
    for k in range(len(outs[0])):
        v = outs[0][k].detach()
        for o in outs[1:]:
            v = v + o[k].detach().to(dev0)
        sums.append(_group_sum(v))
    return tuple(sums) if len(sums) > 1 else sums[0]


class _Shard:
    """One shard's view of the whole batch, for ``models/mlp.py``'s
    BatchNorm and dropout (``sharded_batch``): moments summed over every
    shard in mesh order (and the process group), dropout uniforms drawn
    once for the whole batch (every process's samples, in rank order) from
    the first replica's generator and sliced."""

    def __init__(self, i: int, state: "_BatchState"):
        self.i, self.state = i, state

    def moments(self, x):
        st = self.state
        sums = st.exchange(self.i, torch.stack([x.sum(dim=1),
                                                torch.square(x).sum(dim=1)]))
        n = st.total
        return n, sums[0] / n, sums[1] / n

    def uniform(self, x):
        st = self.state
        k = st.calls[self.i]
        st.calls[self.i] += 1
        with st.lock:
            if k not in st.draws:
                shape = (x.shape[0], st.total, *x.shape[2:])
                st.draws[k] = torch.rand(shape, generator=st.generator,
                                         device=st.generator.device)
        lo = st.offsets[self.i]
        return st.draws[k][:, lo:lo + x.shape[1]].to(x.device)


class _BatchState:
    """What the shards of one step share: the exchange slots and barrier,
    the dropout draws, each shard's offset into the whole batch."""

    def __init__(self, mesh: BatchMesh, sizes, generator):
        self.mesh = mesh
        self.barrier = threading.Barrier(mesh.size)
        self.slots = [None] * mesh.size
        self.result = None
        self.lock = threading.Lock()
        self.draws = {}
        self.calls = [0] * mesh.size
        local = int(sum(sizes))
        self.total = local * group_size()
        self.offsets = (group_rank() * local + np.concatenate(
            [[0], np.cumsum(sizes)[:-1]])).tolist()
        self.generator = generator

    def exchange(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Every shard's ``t`` summed in mesh order (and over the process
        group), on shard i's device; differentiable."""
        self.slots[i] = t
        self.barrier.wait()
        if i == 0:
            tot = self.slots[0]
            for s in self.slots[1:]:
                tot = tot + s.to(tot.device)
            self.result = _group_sum(tot)
        self.barrier.wait()
        out = self.result.to(t.device)
        self.barrier.wait()
        return out


def make_sharded_generic_step(model, optimizer: torch.optim.Optimizer,
                              mesh: BatchMesh, criterion):
    """Data-parallel step for the MLP family (``models/mlp.py``):
    ``step(x_b, y_b) -> loss``, the whole batch's ``criterion`` (a batch
    mean), 0-d on the first placement. ``x_b`` / ``y_b`` are (B, ...)
    arrays, sharded over the mesh, or ``shard_batch`` tuples. BatchNorm
    normalises by the whole batch's moments and its running statistics
    take them; dropout masks are drawn for the whole batch from
    ``model``'s generator and split. So the step equals the single-device
    step ``criterion(model(x), y)`` up to float reassociation; ``optimizer``
    updates ``model`` in place (parameters, then statistics), and the
    replicas follow."""
    reps = _Replicas(model, mesh)

    def step(x_b, y_b):
        x_s, y_s = _shards(mesh, (x_b, y_b))
        sizes = [s.shape[0] for s in x_s]
        state = _BatchState(mesh, sizes, model.generator)
        total = _batch_total(x_s)

        def shard(i):
            m = reps.modules[i]
            m.train()
            with sharded_batch(_Shard(i, state)):
                pred = m(x_s[i])
            return (criterion(pred, y_s[i]) * (sizes[i] / total),)

        return _update(reps, optimizer,
                       _run_shards(mesh, shard, state.barrier))

    return step
