"""GSR-Net family: the adapter that drives the port's fold-parallel CV
pipeline (``fcsr_tpu_torch.pipelines.run_gsr_cv_fast``), the model's
operation and byte counts from its equations, and the comparison with the
plain reference (``reference/gsr_net.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import kfold, sub_seed, teacher_connectomes
from ..reference import common, gsr_net as ref
from .shared import Adapter, fold_rows, init_weights, product_flops

__all__ = ["Cell", "sample_products", "unet_products", "tail_products",
           "step_bytes"]

B1 = 0.9


def unet_products(lr_dim, hr_dim, ks):
    """The U-Net's products on identity features (one per parameter set:
    the branch is the same for every subject)."""
    n, m = lr_dim, hr_dim
    sizes = ref.pool_sizes(n, ks)
    rows = [n] + list(sizes[:-1])
    prods = [(1, n, n, m, False, True)]                        # start
    prods += [(1, r, m, m, True, True) for r in rows]          # down
    prods += [(1, r, m, 1, True, True) for r in rows]          # pools
    prods += [(1, sizes[-1], m, m, True, True)]                # bottom
    prods += [(1, r, m, m, True, True) for r in rows[::-1]]    # up
    prods += [(1, n, 2 * m, m, True, True)]                    # end
    return prods


def tail_products(lr_dim, hr_dim, hidden_dim):
    """One subject's spectral layer and GCN decoder."""
    n, m, h = lr_dim, hr_dim, hidden_dim
    return [(1, m, n, n, True, False), (1, m, n, m, True, True),
            (1, m, m, m, True, True), (1, m, m, h, True, True),
            (1, m, m, h, True, True), (1, m, h, m, True, True),
            (1, m, m, m, True, True)]


def sample_products(lr_dim, hr_dim, hidden_dim, ks):
    return unet_products(lr_dim, hr_dim, ks) + tail_products(
        lr_dim, hr_dim, hidden_dim)


def step_bytes(n_params, lr_dim, hr_dim):
    """A sample-step's least traffic: p, m and v read and written once,
    the sample's U_lr, U_hr[:, :n] and label read once."""
    n, m = lr_dim, hr_dim
    return 4 * (6 * n_params + n * n + m * n + m * m)


class Cell(Adapter):
    """One run's inputs (data, fold plan and initial weights from the
    seed), the program's configuration, and the calls into the program."""

    def __init__(self, cfg, mix, seed, device, control=None, fault=None):
        pub = cfg["published"]
        self.cfg, self.mix, self.device = cfg, mix, device
        self.ks = tuple(pub["ks"])
        self.dims = (pub["lr_dim"], pub["hr_dim"], pub["hidden_dim"])
        self.lmbda, self.lr = float(pub["lmbda"]), float(pub["lr"])
        self.epochs = int(pub["epochs"])
        self.splits = int(mix["splits"])
        if control not in (None, "bf16"):
            raise ValueError(f"gsr_net has no control {control!r}")
        from fcsr_tpu_torch.core import mm_mode
        from fcsr_tpu_torch.train.gsr_loop import GSRTrainConfig
        if control == "bf16":
            # the program's own one-pass bf16 products (FCSR_MM_MODE=bf16)
            self._set(mm_mode, "MODE", "bf16")
        lr, hr, lr_test = teacher_connectomes(
            mix["n_train"], *self.dims[:2], seed=sub_seed(seed, 0),
            n_test=mix["n_test"])
        self.data = {"lr_train": lr, "hr_train": hr, "lr_test": lr_test}
        self.fold_seed = sub_seed(seed, 1)
        self.folds = kfold(len(lr), self.splits, self.fold_seed)
        spec = ref.param_spec(*self.dims, len(self.ks))
        self.n_params = sum(int(np.prod(s)) for _, s, _, _ in spec)
        _, self.w0 = init_weights(spec, self.splits, sub_seed(seed, 2),
                                  device)
        from fcsr_tpu_torch.iox.weights import state_to_flat
        host = {k: v.cpu().numpy() for k, v in self.w0.items()}
        self.flat0 = np.stack([state_to_flat({k: v[f] for k, v in
                                              host.items()})
                               for f in range(self.splits)])
        self.pcfg = GSRTrainConfig(
            epochs=self.epochs, lr=self.lr, lmbda=self.lmbda,
            lr_dim=self.dims[0], hr_dim=self.dims[1],
            hidden_dim=self.dims[2], padding=int(pub["padding"]),
            ks=self.ks, **cfg["program"]["flags"])
        if fault is not None:
            self._plant(fault)

    # -- the program -------------------------------------------------------

    def _entry(self, cfg):
        from fcsr_tpu_torch import pipelines
        return pipelines.run_gsr_cv_fast(
            self.data, cfg, splits=self.splits, seed=self.fold_seed,
            flat0=self.initial(), device=self.device)



    def record(self, res):
        """What the per-layer readers need of a run."""
        return {"fold_eval_s": float(res["timings"]["eval"]),
                "epochs": [self.epochs] * self.splits}

    def run_flops(self, rec):
        """Operations one CV run needs by the model's equations: every
        valid training sample-step forward and backward, and forward only
        the fold evaluation (the U-Net once a fold, the tail once a
        validation subject) and the test predictions (the last fold's
        U-Net once, the tail once a test subject)."""
        n, m, h = self.dims
        step = product_flops(sample_products(n, m, h, self.ks), True)
        u_fwd = product_flops(unet_products(n, m, self.ks), False)
        t_fwd = product_flops(tail_products(n, m, h), False)
        train = sum(len(tr) * e for (tr, _), e in zip(self.folds,
                                                      rec["epochs"]))
        n_val = sum(len(va) for _, va in self.folds)
        n_test = len(self.data["lr_test"])
        return (train * step + self.splits * u_fwd + n_val * t_fwd
                + u_fwd + n_test * t_fwd)

    def profile_slice(self, profile):
        """A runner of ``profile_epochs`` epochs at the cell's shapes: its
        first ``train()`` captures the epoch graph, the second (the graph
        replayed) is profiled. Returns the profile and the slice's work."""
        from fcsr_tpu_torch.train.fast_loop import GSRFoldRunner
        cfg = dataclasses.replace(
            self.pcfg, epochs=int(self.cfg["program"]["profile_epochs"]))
        runner = GSRFoldRunner(cfg, self.data["lr_train"],
                               self.data["hr_train"], self.folds,
                               flat0=self.initial(), device=self.device)
        runner.train()
        self._sync()
        prof = profile(runner.train)
        runner.release_graphs()
        n, m, h = self.dims
        samples = sum(len(tr) for tr, _ in self.folds) * cfg.epochs
        work = {"steps": cfg.epochs * runner.tr_idx.shape[1],
                "flops": samples * product_flops(
                    sample_products(n, m, h, self.ks), True),
                "bytes": samples * step_bytes(self.n_params, n, m)}
        del runner
        return prof, work

    # -- the outputs and the reference --------------------------------------

    def take_outputs(self, res):
        """The program's outputs to the host, and the first three steps of
        the run's own runner (its step function, the one its epoch graph
        captured) from the benchmark's initial weights."""
        from fcsr_tpu_torch.iox.weights import leaf_tensors_to_state
        from fcsr_tpu_torch.models.fused_step import adam_scalars
        runner = res["runner"]
        p, m, v, t = runner.fresh_state()
        p0 = p.clone()
        losses = []

        def named_norms(flat):
            views = leaf_tensors_to_state(runner.layout.views(
                flat.contiguous()))
            return [{k: float(x[f].double().norm()) for k, x in views.items()}
                    for f in range(self.splits)]
        g1 = None
        for s in range(3):
            scal, t = adam_scalars(t, runner.tr_valid[:, s])
            loss, _, p, m, v = runner._step(
                p, m, v, s, torch.from_numpy(scal).to(p.device))
            losses.append(loss.double().cpu().numpy())
            if g1 is None:
                g1 = named_norms(m / (1.0 - B1))
        out = {"fold_maes": [float(x) for x in res["fold_maes"]],
               "test_preds": res["test_preds"].detach().float().cpu(),
               "params": [{k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in st.items()}
                          for st in res["params_per_fold"]],
               "losses": np.stack(losses), "g1": g1,
               "dp": named_norms(p - p0)}
        runner.release_graphs()
        return out

    def check(self, out):
        """The numbers compared, each with its readings: see ``PERF.md``.
        The first three steps are judged by the median fold: a last-bit
        difference can flip a pool's top-k in one fold (the pools' scores
        lie within an ulp or two of a tie) and part its trajectory there;
        a broken step breaks every fold, or half of them."""
        dev = self.device
        common.strict_fp32()
        lr, hr = self.data["lr_train"], self.data["hr_train"]
        u_lr, u_hr = common.spectral_bases(lr, hr, self.dims[0])
        u_lr_d = torch.from_numpy(u_lr).to(dev)
        hr_d = torch.from_numpy(hr).to(dev)
        u_hr_d = torch.from_numpy(np.ascontiguousarray(u_hr)).to(dev)
        mae_gap = ratio = 0.0
        start = {"step_loss_gap": [], "grad_norm_gap": [],
                 "update_norm_gap": []}
        self.notes = {"worst_grad_leaf": [], "pool_margin": []}
        for f, (tr, va) in enumerate(self.folds):
            P0 = {k: x[f] for k, x in self.w0.items()}
            samples = [(u_lr_d[i], u_hr_d[i], hr_d[i]) for i in tr[:3]]
            losses, g1, P3 = ref.adam_steps(P0, self.ks, self.lmbda,
                                            self.lr, samples)
            start["step_loss_gap"].append(max(
                abs(out["losses"][s][f] - x) / abs(x)
                for s, x in enumerate(losses)))
            g_ref = {k: float(g.double().norm()) for k, g in g1.items()}
            d_ref = {k: float((P3[k] - P0[k]).double().norm()) for k in P0}
            med = float(np.median(list(g_ref.values())))
            moved = {k for k, x in g_ref.items() if x >= 1e-3 * med}
            gaps = common.norm_gaps(out["g1"][f], g_ref)
            worst = max(gaps, key=gaps.get)
            start["grad_norm_gap"].append(gaps[worst])
            start["update_norm_gap"].append(max(common.norm_gaps(
                out["dp"][f], d_ref, moved).values()))
            self.notes["worst_grad_leaf"].append(worst)
            with torch.no_grad():
                self.notes["pool_margin"].append(
                    ref.unet(P0, self.ks, self.dims[0])[2])
            Pt = {k: x.to(dev) for k, x in out["params"][f].items()}
            mae = ref.fold_mae(Pt, self.ks, u_lr_d[va], hr_d[va])
            mae0 = ref.fold_mae(P0, self.ks, u_lr_d[va], hr_d[va])
            mae_gap = max(mae_gap, abs(out["fold_maes"][f] - mae) / mae)
            ratio = max(ratio, mae / mae0)
        u_test, _ = common.spectral_bases(self.data["lr_test"])
        P_last = {k: x.to(dev) for k, x in out["params"][-1].items()}
        pred, _ = ref.predict(P_last, self.ks,
                              torch.from_numpy(u_test).to(dev))
        self.notes.update(start)
        values = {k: float(np.median(v)) for k, v in start.items()}
        values.update(fold_mae_gap=mae_gap, trained_mae_ratio=ratio,
                      test_pred_gap=common.rel_gap(out["test_preds"],
                                                   pred.cpu()))
        return values

    # -- planted faults (the check's own readings and tests; never in a
    #    measured run), undone by ``close`` --------------------------------

    def _plant(self, fault):
        from fcsr_tpu_torch import pipelines
        from fcsr_tpu_torch.train import fast_loop
        if fault in ("frozen_step", "half_batch"):
            real = fast_loop.train_step_fused
            rows = fold_rows(self.splits, "half" if fault == "half_batch"
                             else "all")

            def step(p, m, v, *args, **kwargs):
                loss, err, p2, m2, v2 = real(p, m, v, *args, **kwargs)
                keep = self._fold_mask(p, rows)
                return (loss, err, torch.where(keep, p, p2),
                        torch.where(keep, m, m2), torch.where(keep, v, v2))
            self._set(fast_loop, "train_step_fused", step)
        elif fault == "altered_answer":
            real = pipelines.predict_gsr
            real_eval = pipelines.evaluate_gsr_folds

            def predict(*args, **kwargs):
                out = real(*args, **kwargs)
                return out + 1e-3 * out.abs().max()

            def evaluate(*args, **kwargs):
                maes, outs = real_eval(*args, **kwargs)
                return [m * (1 + 1e-3) for m in maes], outs
            self._set(pipelines, "predict_gsr", predict)
            self._set(pipelines, "evaluate_gsr_folds", evaluate)
        else:
            raise ValueError(f"unknown fault {fault!r}")

