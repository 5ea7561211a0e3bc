"""MLP family (v2, the spectral-norm residual MLP): the adapter that drives
the port's MLP CV pipeline (``fcsr_tpu_torch.pipelines.run_mlp_cv``, as
``train mlp`` runs it), the step's operation and byte counts from the
model's equations, and the comparison with the plain reference
(``reference/mlp_v2.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..data import sub_seed, teacher_connectomes
from ..reference import common, mlp_v2 as ref
from .shared import Adapter, fold_rows, product_flops

__all__ = ["Cell", "window_folds", "sample_products", "sn_products",
           "step_bytes", "forward_bytes"]

STEPS = 3          # the training steps the check follows
B1 = 0.9
# the leaves whose gradient BatchNorm centres over the batch
BN_FED = ("input_layer.1.weight_orig", "input_layer.1.bias")


def window_folds(n, k, p_val, seed):
    """[(train, val)] of the MLP pipeline's contiguous-window plan (a
    frozen copy of ``fcsr_tpu_torch/data/datamodule.py::
    contiguous_window_folds``): one permutation of ``range(n)`` from
    ``np.random.default_rng(seed)``; fold j validates on its window of
    ``int(n * p_val)`` and trains on the rest in permutation order."""
    indices = np.random.default_rng(seed).permutation(n)
    size = int(n * p_val)
    return [(np.concatenate([indices[:j * size], indices[(j + 1) * size:]]),
             indices[j * size:(j + 1) * size]) for j in range(k)]


def sample_products(l_in, hidden, l_out):
    """One sample's products: the input layer (its input is data) and the
    output layer."""
    return [(1, 1, l_in, hidden, False, True),
            (1, 1, hidden, l_out, True, True)]


def sn_products(l_in, hidden, l_out, train):
    """A forward's spectral-norm products, once a batch: in training the
    power iteration's two matrix-vector products (no gradient) and sigma's
    ``W v`` (its gradient through W); in evaluation ``W v`` alone."""
    out = []
    for a, b in ((l_in, hidden), (hidden, l_out)):
        if train:
            out += [(1, 1, b, a, False, False), (1, 1, a, b, False, False)]
        out.append((1, b, a, 1, train, False))
    return out


def step_bytes(n_params, n_stats, batch, l_in, l_out):
    """A fold's training step's least traffic: p, m and v read and written
    once, the statistics read and written once, the batch's inputs and
    labels read once."""
    return 4 * (6 * n_params + 2 * n_stats + batch * (l_in + l_out))


def forward_bytes(n_params, n_stats, batch, l_in, l_out):
    """A fold's evaluation forward of ``batch`` subjects: the parameters,
    the statistics and the subjects read once, the predictions written."""
    return 4 * (n_params + n_stats + batch * (l_in + l_out))


class Cell(Adapter):
    """One run's inputs, the program's settings and the calls into the
    program (see ``families/gsr.py``)."""

    def __init__(self, cfg, mix, seed, device, control=None, fault=None):
        pub = cfg["published"]
        self.cfg, self.mix, self.device = cfg, mix, device
        self.n, self.m = int(pub["n_in"]), int(pub["n_out"])
        self.hidden = int(pub["hidden"])
        self.l_in = self.n * (self.n - 1) // 2
        self.l_out = self.m * (self.m - 1) // 2
        self.splits = int(mix["splits"])
        self.batch = int(pub["batch_size"])
        self.p_drop = float(pub["dropout"])
        if control == "tf32":
            # the program's float32 products on the tensor cores in TF32
            self._set(torch.backends.cuda.matmul, "allow_tf32", True)
            self._set(torch.backends.cudnn, "allow_tf32", True)
        elif control is not None:
            raise ValueError(f"mlp_v2 has no control {control!r}")
        lr, hr, lr_test = teacher_connectomes(
            mix["n_train"], self.n, self.m, seed=sub_seed(seed, 0),
            n_test=mix["n_test"])
        self.data = {"lr_train": lr, "hr_train": hr, "lr_test": lr_test}
        self.fold_seed = sub_seed(seed, 1)
        self.folds = window_folds(len(lr), self.splits, float(pub["p_val"]),
                                  self.fold_seed)
        self.seeds = [self.fold_seed + j for j in range(self.splits)]
        self.pspec = ref.param_spec(self.n, self.m, self.hidden)
        self.sspec = ref.stat_spec(self.n, self.m, self.hidden)
        self.n_params = sum(int(np.prod(s)) for _, s, _, _ in self.pspec)
        self.n_stats = sum(int(np.prod(s)) for _, s, _ in self.sspec)
        self.w0, self.s0 = self._init_weights(sub_seed(seed, 2))
        from fcsr_tpu_torch.iox.weights import mlp_state_to_flat
        host = {k: v.cpu().numpy() for k, v in (self.w0 | self.s0).items()}
        flats = [mlp_state_to_flat({k: v[f] for k, v in host.items()})
                 for f in range(self.splits)]
        self.flat0 = tuple(np.stack(x) for x in zip(*flats))
        self.kw = dict(k_folds=self.splits, p_val=float(pub["p_val"]),
                       num_epochs=int(pub["epochs"]), lr=float(pub["lr"]),
                       batch_size=self.batch, n_layers=int(pub["n_layers"]),
                       hidden=self.hidden, seed=self.fold_seed,
                       **cfg["program"]["flags"])
        if fault is not None:
            self._plant(fault)

    def _init_weights(self, seed):
        """The folds' initial tensors by name, (F, *shape) on the device,
        from ``seed``: one uniform draw over the parameters' stack and one
        normal draw over the statistics' stack, each leaf made by its
        initialiser."""
        F, dev = self.splits, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        uni = torch.rand((F, self.n_params), generator=gen, device=dev)
        nrm = torch.randn((F, self.n_stats), generator=gen, device=dev)
        params, stats, off = {}, {}, 0
        for name, shape, kind, scale in self.pspec:
            size = int(np.prod(shape))
            x = uni[:, off:off + size].reshape(F, *shape)
            off += size
            params[name] = (x * 2.0 - 1.0) * scale if kind == "uniform" \
                else torch.full_like(x, float(kind == "ones"))
        off = 0
        for name, shape, kind in self.sspec:
            size = int(np.prod(shape))
            x = nrm[:, off:off + size].reshape(F, *shape)
            off += size
            stats[name] = x / torch.linalg.vector_norm(
                x, dim=-1, keepdim=True) if kind == "unit_normal" \
                else torch.full_like(x, float(kind == "ones"))
        return params, stats

    # -- the program -------------------------------------------------------

    def initial(self):
        """The (p, s) handed to the program: on the CPU copies, since the
        program stages them with ``torch.from_numpy`` and trains them in
        place there."""
        if torch.device(self.device).type == "cuda":
            return self.flat0
        return tuple(a.copy() for a in self.flat0)

    def _entry(self, kw):
        from fcsr_tpu_torch import pipelines
        return pipelines.run_mlp_cv(self.data, **kw, flat0=self.initial(),
                                    device=self.device)

    def warm(self):
        """One CV run of the mix's ``warm_epochs`` through the timed
        entry: builds the kernels, captures the epoch and validation
        graphs once, runs the fold evaluation and the test predictions at
        the cell's shapes."""
        res = self._entry(dict(self.kw,
                               num_epochs=int(self.mix["warm_epochs"])))
        self._sync()
        if "variables_per_fold" not in res:
            # the check needs every fold's returned state
            raise SystemExit("run_mlp_cv returns no variables_per_fold: "
                             "this program cannot be checked in this cell")

    def run_once(self):
        res = self._entry(self.kw)
        self._sync()
        return res

    def record(self, res):
        return {"fold_eval_s": float(res["timings"]["eval"]),
                "epochs": [len(h[0]) for h in res["histories"]]}

    def _epoch_work(self, n_tr, n_va):
        """(operations, bytes) of one fold's epoch: its training steps
        (full batches, then the remainder) and one validation pass."""
        sample = sample_products(self.l_in, self.hidden, self.l_out)
        sizes = [self.batch] * (n_tr // self.batch) + (
            [n_tr % self.batch] if n_tr % self.batch else [])
        sn_tr = product_flops(sn_products(self.l_in, self.hidden,
                                          self.l_out, True), True)
        flops = sum(b * product_flops(sample, True) + sn_tr for b in sizes)
        flops += self._forward_flops(n_va)
        nbytes = sum(step_bytes(self.n_params, self.n_stats, b, self.l_in,
                                self.l_out) for b in sizes)
        nbytes += forward_bytes(self.n_params, self.n_stats, n_va,
                                self.l_in, self.l_out)
        return flops, nbytes, len(sizes)

    def _forward_flops(self, batch):
        return batch * product_flops(sample_products(
            self.l_in, self.hidden, self.l_out), False) + product_flops(
            sn_products(self.l_in, self.hidden, self.l_out, False), False)

    def run_flops(self, rec):
        """Operations one CV run needs by the equations: each fold's
        training steps and validation pass in the epochs it trained, the
        fold evaluation's and the test predictions' forwards."""
        total = 0
        for (tr, va), e in zip(self.folds, rec["epochs"]):
            total += e * self._epoch_work(len(tr), len(va))[0]
            total += self._forward_flops(len(va))
        return total + self._forward_flops(len(self.data["lr_test"]))

    def _trainer(self):
        """The fold-parallel trainer as ``run_mlp_cv`` builds it (its
        model, criterion, packed targets, fold stacks and seeds) on a copy
        of the benchmark's initial weights."""
        from fcsr_tpu_torch.models.mlp import SpectralResMLP
        from fcsr_tpu_torch.train import generic_loop
        from fcsr_tpu_torch.train.losses import (make_triu_mse_criterion,
                                                 pack_triu_targets)
        model = SpectralResMLP(self.n, self.m, self.hidden,
                               int(self.kw["n_layers"]), output="vector",
                               device="meta")
        r, c = np.triu_indices(self.n, 1)
        x = self.data["lr_train"][:, r, c]
        y = pack_triu_targets(self.data["hr_train"])
        tr_idx = np.stack([t for t, _ in self.folds])
        va_idx = np.stack([v for _, v in self.folds])
        p, s = (torch.from_numpy(a.copy()).to(self.device)
                for a in self.flat0)
        pub = self.cfg["published"]
        return generic_loop._FoldTrainer(
            model, p, s, x[tr_idx], y[tr_idx], x[va_idx], y[va_idx],
            self.seeds[0], self.batch, make_triu_mse_criterion(self.m),
            float(pub["clip_norm"]), float(pub["weight_decay"]),
            torch.device(self.device))

    def _control(self, tr, epochs):
        """``epochs`` epochs of ``tr`` under the pipeline's on-device
        control."""
        from fcsr_tpu_torch.train import generic_loop
        pub = self.cfg["published"]
        rngs = [np.random.default_rng(s) for s in self.seeds]
        return generic_loop._device_control(
            tr, rngs, epochs, float(pub["lr"]), lambda e: True,
            int(pub["patience"]), float(pub["plateau_threshold"]),
            float(pub["plateau_factor"]), float(pub["stop_lr"]), epochs)

    def profile_slice(self, profile):
        """The trainer of the cell's shapes under its on-device control:
        one epoch captures the epoch and validation graphs, the next
        ``profile_epochs`` (the graphs replayed) are profiled."""
        epochs = int(self.cfg["program"]["profile_epochs"])
        tr = self._trainer()
        self._control(tr, 1)
        self._sync()
        prof = profile(lambda: self._control(tr, epochs))
        tr.release_graphs()
        flops = nbytes = steps = 0
        for t, v in self.folds:
            f, b, steps = self._epoch_work(len(t), len(v))
            flops, nbytes = flops + f, nbytes + b
        del tr
        return prof, {"steps": epochs * steps, "flops": epochs * flops,
                      "bytes": epochs * nbytes}

    # -- the outputs and the reference --------------------------------------

    def take_outputs(self, res):
        """The program's outputs to the host, and its first ``STEPS``
        training steps from the benchmark's initial weights: the trainer
        the pipeline builds, its ``step`` (the one its epoch graph
        captures; eager, the replay is bit-equal) on each fold's first
        ``STEPS`` batches in training order, dropout drawn from its own
        generator as in a run's first epoch."""
        from fcsr_tpu_torch.train.generic_loop import fold_state
        tr = self._trainer()
        dev = tr.p.device
        p0 = tr.p.clone()
        pnames = {n for n, *_ in self.pspec}

        def by_name(flat_p, keep):
            return [{k: v.detach() for k, v in fold_state(
                tr.model, flat_p, tr.s, f).items() if keep(k)}
                for f in range(self.splits)]

        def norms(flat):
            return [{k: float(v.double().norm()) for k, v in st.items()}
                    for st in by_name(flat, pnames.__contains__)]
        ok = torch.ones(self.splits, device=dev)
        lr = torch.full((self.splits,), float(self.kw["lr"]), device=dev)
        losses, g1 = [], None
        for s in range(STEPS):
            idx = torch.arange(s * self.batch, (s + 1) * self.batch,
                               device=dev).expand(self.splits, -1)
            losses.append(tr.step(idx, ok, lr).double().cpu().numpy())
            if g1 is None:
                g1 = norms(tr.m / (1.0 - B1))
        dp = norms(tr.p - p0)
        stats = [{k: v.float().cpu() for k, v in st.items()}
                 for st in by_name(tr.p, lambda k: k not in pnames)]
        del tr, p0

        def host(st):
            return {k: v.detach().float().cpu().contiguous()
                    for k, v in st.items()}
        return {"fold_maes": [float(x) for x in res["fold_maes"]],
                "test_preds": res["test_preds"].detach().float().cpu(),
                "states": [host(st) for st in res["variables_per_fold"]],
                "histories": res["histories"],
                "losses": np.stack(losses), "g1": g1, "dp": dp,
                "stats": stats}

    def check(self, out):
        """The numbers compared, each with its readings: see ``PERF.md``.
        The first steps are judged by the median fold, as the other
        families'."""
        dev = self.device
        common.strict_fp32()
        pub = self.cfg["published"]
        lr, wd = float(pub["lr"]), float(pub["weight_decay"])
        x = ref.triangle(torch.from_numpy(self.data["lr_train"]).to(dev))
        hr = torch.from_numpy(self.data["hr_train"]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(self.seeds[0])
        keeps = ref.keep_masks(gen, self.splits, self.batch, self.hidden,
                               self.p_drop, STEPS)
        names = [n for n, *_ in self.pspec]
        start = {"step_loss_gap": [], "grad_norm_gap": [],
                 "update_norm_gap": [], "stats_gap": []}
        mae_gap = val_gap = ratio = 0.0
        control = unmoved = counted = 0
        self.notes = {"worst_grad_leaf": [], "worst_stat": [],
                      "worst_update_leaf": [], "bn_fed_update_gap": []}
        for f, (tr, va) in enumerate(self.folds):
            P0 = {k: v[f] for k, v in self.w0.items()}
            S0 = {k: v[f] for k, v in self.s0.items()}
            batches = [(x[tr[s * self.batch:(s + 1) * self.batch]],
                        hr[tr[s * self.batch:(s + 1) * self.batch]])
                       for s in range(STEPS)]
            losses, g1, P3, S3 = ref.adamw_steps(
                P0, S0, batches, [k[f] for k in keeps], lr, wd,
                float(pub["clip_norm"]), self.p_drop)
            start["step_loss_gap"].append(max(
                abs(out["losses"][s][f] - v) / abs(v)
                for s, v in enumerate(losses)))
            g_ref = {k: float(g.double().norm()) for k, g in g1.items()}
            d_ref = {k: float((P3[k] - P0[k]).double().norm())
                     for k in names}
            med = float(np.median(list(g_ref.values())))
            # the leaves the reference's first gradient moves (a thousandth
            # of the median leaf's norm or more)
            moved = {k for k, v in g_ref.items() if v >= 1e-3 * med}
            gaps = common.norm_gaps(out["g1"][f], g_ref)
            worst = max(gaps, key=gaps.get)
            start["grad_norm_gap"].append(gaps[worst])
            # the update's number leaves out the leaves that feed
            # BatchNorm: their gradient is centred over the batch, a sum
            # that cancels on inputs that are all positive; the program's
            # one-pass variance (mean(h^2) - mean^2, as the JAX package's)
            # leaves a residue there that sets the sign of their small
            # entries, and Adam moves each of those by +-lr either way.
            # Their gap goes to the notes
            u_gaps = common.norm_gaps(out["dp"][f], d_ref, moved)
            kept = {k: v for k, v in u_gaps.items() if k not in BN_FED}
            start["update_norm_gap"].append(max(kept.values()))
            self.notes["worst_update_leaf"].append(max(kept, key=kept.get))
            self.notes["bn_fed_update_gap"].append(
                max((u_gaps[k] for k in BN_FED if k in u_gaps), default=0.0))
            s_gaps = {k: common.rel_gap(out["stats"][f][k], S3[k].cpu())
                      for k in S3}
            worst_s = max(s_gaps, key=s_gaps.get)
            start["stats_gap"].append(s_gaps[worst_s])
            self.notes["worst_grad_leaf"].append(worst)
            self.notes["worst_stat"].append(worst_s)
            st = {k: v.to(dev) for k, v in out["states"][f].items()}
            Pb = {k: st[k] for k in names}
            Sb = {k: st[k] for k in S0}
            counted += len(moved)
            unmoved += sum(int(torch.equal(Pb[k], P0[k])) for k in moved)
            mse, mae = ref.evaluate(Pb, Sb, x[va], hr[va])
            _, mae0 = ref.evaluate(P0, S0, x[va], hr[va])
            mae, mse = float(mae.double().mean()), float(mse.double().mean())
            mae_gap = max(mae_gap, abs(out["fold_maes"][f] - mae) / mae)
            ratio = max(ratio, mae / float(mae0.double().mean()))
            train_h, val_h, lr_h = out["histories"][f]
            val_gap = max(val_gap, abs(min(val_h) - mse) / mse)
            lrs, expect = ref.plateau_replay(
                val_h, lr, int(pub["patience"]),
                float(pub["plateau_threshold"]),
                float(pub["plateau_factor"]), float(pub["stop_lr"]),
                int(pub["epochs"]))
            control += sum(int(np.float32(a) != b)
                           for a, b in zip(lr_h, lrs))
            control += int(len(val_h) != expect) + int(
                len(train_h) != len(val_h))
        x_t = ref.triangle(torch.from_numpy(self.data["lr_test"]).to(dev))
        st = {k: v.to(dev) for k, v in out["states"][-1].items()}
        with torch.no_grad():
            pred = ref.to_matrix(ref.forward(
                {k: st[k] for k in names},
                {k: st[k] for k in self.s0}, x_t, False)[0], self.m)
        self.notes.update(start)
        values = {k: float(np.median(v)) for k, v in start.items()}
        values.update(fold_mae_gap=mae_gap, best_val_gap=val_gap,
                      trained_mae_ratio=ratio,
                      control_mismatch=float(control),
                      test_pred_gap=common.rel_gap(out["test_preds"],
                                                   pred.cpu()),
                      unmoved_leaf_share=unmoved / max(counted, 1))
        return values

    # -- planted faults (the check's own readings and tests; never in a
    #    measured run), undone by ``close`` --------------------------------

    def _plant(self, fault):
        from fcsr_tpu_torch import pipelines
        from fcsr_tpu_torch.kernels import ops
        from fcsr_tpu_torch.models import mlp
        from fcsr_tpu_torch.train import generic_loop
        if fault in ("frozen_step", "half_batch", "wrong_lr"):
            real = generic_loop.KERNEL_OPS
            rows = fold_rows(self.splits, "half" if fault == "half_batch"
                             else "all")
            adapter = self

            class Ops:
                def __getattr__(self, name):
                    return getattr(real, name)

                @staticmethod
                def adamw_masked(p, m, v, g, scal, *args, **kwargs):
                    # the update's fold scalars [ok, lr, ...]: the folds
                    # of ``rows`` masked, or every rate ten times
                    if fault == "wrong_lr":
                        scal = torch.cat([scal[:, :1], scal[:, 1:2] * 10.0,
                                          scal[:, 2:]], dim=1)
                    else:
                        keep = adapter._fold_mask(scal, rows)
                        scal = torch.cat([torch.where(keep, 0.0,
                                                      scal[:, :1]),
                                          scal[:, 1:]], dim=1)
                    return real.adamw_masked(p, m, v, g, scal, *args,
                                             **kwargs)
            self._set(generic_loop, "KERNEL_OPS", Ops())
        elif fault == "altered_answer":
            real_mae = pipelines._mlp_fold_mae
            real_mats = ops.anti_vectorize_normalize

            def mae(*args, **kwargs):
                return real_mae(*args, **kwargs) * (1 + 1e-3)

            def mats(*args, **kwargs):
                out = real_mats(*args, **kwargs)
                return out + 1e-3 * out.abs().max()
            self._set(pipelines, "_mlp_fold_mae", mae)
            self._set(ops, "anti_vectorize_normalize", mats)
        elif fault == "stale_schedule":
            real_control = generic_loop._device_control

            def control(tr, rngs, epochs, lr0, flag, patience, thr, factor,
                        *rest):
                return real_control(tr, rngs, epochs, lr0, flag, patience,
                                    thr, 1.0, *rest)
            self._set(generic_loop, "_device_control", control)
        elif fault == "stale_power_iteration":
            # SN's u and v left at their initial values: sigma from the
            # initial pair, no power iteration
            real_sn = mlp.sn_dense_fold

            def sn(x, kernel, bias, u, v, update, eps=mlp.SN_EPS):
                return real_sn(x, kernel, bias, u, v, False, eps)
            self._set(mlp, "sn_dense_fold", sn)
        else:
            raise ValueError(f"unknown fault {fault!r}")
