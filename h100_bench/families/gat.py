"""GAT Graph-U-Net family: the adapter that drives the port's
fold-parallel GAT CV pipeline (``fcsr_tpu_torch.pipelines.
run_gat_cv_fast``), the model's operation and byte counts from its
equations, and the comparison with the plain reference
(``reference/gat_unet.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import kfold, sub_seed, teacher_connectomes
from ..reference import common, gat_unet as ref
from .shared import Adapter, fold_rows, init_weights, product_flops

__all__ = ["Cell", "sample_products", "step_bytes"]

STEPS = 3          # the training steps the check follows

def sample_products(n_nodes, m_nodes, dim, ks, heads):
    """One subject's forward products, with which operands depend on the
    parameters (the first layer's input is the data's features)."""
    d = ref.dims(dim, ks)
    sizes = ref.pool_sizes(n_nodes, ks)
    rows = [n_nodes] + list(sizes)
    L = len(ks)
    prods = []

    def gat(r, d_in, d_out, h, data_in=False):
        dh = d_out // h
        prods.append((1, r, d_in, h * dh, not data_in, True))
        prods.append((h, r, r, dh, True, True))
    for i in range(L):
        gat(rows[i], d[i], d[i + 1], heads, data_in=(i == 0))
        prods.append((1, rows[i], d[i + 1], 1, True, True))
    gat(rows[L], d[L], d[L], 2)
    for i in range(L):
        up = L - 1 - i
        gat(rows[up], d[up + 1], d[up], heads)
        prods.append((1, rows[up], d[up], rows[up], True, True))
    prods.append((1, dim, n_nodes, m_nodes, True, True))
    prods.append((1, m_nodes, dim, m_nodes, True, True))
    return prods


def step_bytes(n_params, n_nodes, m_nodes, dim):
    """A sample-step's least traffic: p, m and v read and written once,
    the subject's adjacency, features and label read once."""
    n, m = n_nodes, m_nodes
    return 4 * (6 * n_params + n * n + n * dim + m * m)


def forward_bytes(n_params, n_nodes, m_nodes, dim):
    """A validation forward's: the parameters and the subject read once,
    its loss written."""
    n, m = n_nodes, m_nodes
    return 4 * (n_params + n * n + n * dim + m * m)


class Cell(Adapter):
    """One run's inputs, the program's configuration and the calls into
    the program (see ``families/gsr.py``)."""

    def __init__(self, cfg, mix, seed, device, control=None, fault=None):
        pub = cfg["published"]
        self.cfg, self.mix, self.device = cfg, mix, device
        self.ks = tuple(pub["ks"])
        self.n, self.m = int(pub["n_nodes"]), int(pub["m_nodes"])
        self.dim, self.heads = int(pub["dim"]), int(pub["heads"])
        self.splits = int(mix["splits"])
        if control == "tf32":
            # the program's float32 products on the tensor cores in TF32
            self._set(torch.backends.cuda.matmul, "allow_tf32", True)
            self._set(torch.backends.cudnn, "allow_tf32", True)
        elif control is not None:
            raise ValueError(f"gat_unet has no control {control!r}")
        from fcsr_tpu_torch.train.gat_loop import GATTrainConfig
        lr, hr, lr_test = teacher_connectomes(
            mix["n_train"], self.n, self.m, seed=sub_seed(seed, 0),
            n_test=mix["n_test"])
        self.data = {"lr_train": lr, "hr_train": hr, "lr_test": lr_test}
        self.fold_seed = sub_seed(seed, 1)
        self.folds = kfold(len(lr), self.splits, self.fold_seed)
        spec = ref.param_spec(self.n, self.m, self.dim, self.ks, self.heads)
        self.n_params = sum(int(np.prod(s)) for _, s, _, _ in spec)
        _, self.w0 = init_weights(spec, self.splits, sub_seed(seed, 2),
                                  device)
        from fcsr_tpu_torch.iox.weights import gat_state_to_flat
        host = {k: v.cpu().numpy() for k, v in self.w0.items()}
        self.flat0 = np.stack([gat_state_to_flat({k: v[f] for k, v in
                                                  host.items()})
                               for f in range(self.splits)])
        self.pcfg = GATTrainConfig(
            ks=self.ks, n_nodes=self.n, m_nodes=self.m, dim=self.dim,
            heads=self.heads, drop_p=float(pub["drop_p"]),
            epochs=int(pub["epochs"]), lr=float(pub["lr"]),
            patience=int(pub["patience"]),
            plateau_threshold=float(pub["plateau_threshold"]),
            plateau_factor=float(pub["plateau_factor"]),
            intermediate_losses=bool(pub["intermediate_losses"]),
            weight_decay=float(pub["weight_decay"]),
            **cfg["program"]["flags"])
        self.stop_lr = float(pub["stop_lr"])
        if fault is not None:
            self._plant(fault)

    # -- the program -------------------------------------------------------

    def _entry(self, cfg):
        from fcsr_tpu_torch import pipelines
        return pipelines.run_gat_cv_fast(
            self.data, cfg, splits=self.splits, seed=self.fold_seed,
            flat0=self.initial(), device=self.device)



    def record(self, res):
        return {"fold_eval_s": float(res["timings"]["predict"]),
                "epochs": [len(h["train"]) for h in res["histories"]]}

    def run_flops(self, rec):
        """Operations one CV run needs by the equations: each fold's
        training sample-steps forward and backward and its validation
        forwards in the epochs it trained, the fold evaluation's and the
        test predictions' forwards."""
        prods = sample_products(self.n, self.m, self.dim, self.ks,
                                self.heads)
        step, fwd = product_flops(prods, True), product_flops(prods, False)
        total = 0
        for (tr, va), e in zip(self.folds, rec["epochs"]):
            total += e * (len(tr) * step + len(va) * fwd) + len(va) * fwd
        return total + len(self.data["lr_test"]) * fwd

    def profile_slice(self, profile):
        """The trainer of the cell's shapes under its on-device control:
        one epoch captures the epoch and validation graphs, the next
        ``profile_epochs`` (the graphs replayed) are profiled."""
        from fcsr_tpu_torch.train import gat_loop
        epochs = int(self.cfg["program"]["profile_epochs"])
        tr = gat_loop._FoldTrainer(self.pcfg, self.data["lr_train"],
                                   self.data["hr_train"], self.folds,
                                   self.fold_seed, self.device,
                                   flat0=self.initial())
        gat_loop._run_device_control(
            tr, dataclasses.replace(self.pcfg, epochs=1), False, 1)
        self._sync()
        prof = profile(lambda: gat_loop._run_device_control(
            tr, dataclasses.replace(self.pcfg, epochs=epochs), False,
            epochs))
        tr.release_graphs()
        prods = sample_products(self.n, self.m, self.dim, self.ks,
                                self.heads)
        n_tr = sum(len(t) for t, _ in self.folds) * epochs
        n_va = sum(len(v) for _, v in self.folds) * epochs
        work = {"steps": epochs * tr.tr_len,
                "flops": n_tr * product_flops(prods, True)
                + n_va * product_flops(prods, False),
                "bytes": n_tr * step_bytes(self.n_params, self.n, self.m,
                                           self.dim)
                + n_va * forward_bytes(self.n_params, self.n, self.m,
                                       self.dim)}
        del tr
        return prof, work

    # -- the outputs and the reference --------------------------------------

    def take_outputs(self, res):
        """The program's outputs to the host, and its first ``STEPS``
        training steps from the benchmark's initial weights: the trainer
        the pipeline builds (``train_gat_folds_parallel``'s
        ``_FoldTrainer`` on the same data, folds, seed and weights), driven
        through the step its epoch graph captures (``epoch_step``, eager:
        the replay is bit-equal) on each fold's first training subjects,
        its dropout drawn from its own generator as in a run's first
        epoch."""
        from fcsr_tpu_torch.iox.weights import gat_leaf_tensors_to_state
        from fcsr_tpu_torch.train import gat_loop
        tr = gat_loop._FoldTrainer(
            self.pcfg, self.data["lr_train"], self.data["hr_train"],
            self.folds, self.fold_seed, self.device, flat0=self.initial(),
            fused=self.pcfg.fused_step)

        def named_norms(flat):
            views = tr.layout.views(flat.contiguous())
            return [{k: float(x.double().norm()) for k, x in
                     gat_leaf_tensors_to_state(
                         {n: t[f] for n, t in views.items()}).items()}
                    for f in range(self.splits)]
        p, m, v = tr.p.clone(), tr.m.clone(), tr.v.clone()
        p0, losses, g1 = p.clone(), [], None
        for s in range(STEPS):
            i = torch.tensor([int(t[s]) for t, _ in self.folds],
                             device=p.device)
            scal = torch.tensor([[1.0, self.pcfg.lr, s + 1.0]] * self.splits,
                                dtype=torch.float32, device=p.device)
            loss, p, m, v = tr.epoch_step(p, m, v, i, scal, None)
            losses.append(loss.detach().double().cpu().numpy())
            if g1 is None:
                g1 = named_norms(m / (1.0 - ref.B1))
        dp = named_norms(p - p0)
        del tr, p, m, v, p0
        return {"fold_maes": [float(x) for x in res["fold_maes"]],
                "test_preds": res["test_preds"].detach().float().cpu(),
                "params": [{k: torch.from_numpy(np.asarray(v, np.float32))
                            for k, v in st.items()}
                           for st in res["variables_per_fold"]],
                "histories": res["histories"],
                "losses": np.stack(losses), "g1": g1, "dp": dp}

    def _replay_control(self, hist):
        """Mismatches between a fold's recorded learning rates and epochs
        and the plateau rule replayed in float32 over its recorded
        validation losses (improvement below ``best (1 - threshold)``,
        decay by ``factor`` after more than ``patience`` epochs without
        one, stop once the rate falls below ``stop_lr``)."""
        f32 = np.float32
        cfg = self.pcfg
        lr, best, bad = f32(cfg.lr), f32(np.inf), 0
        shrink, factor = f32(1.0 - cfg.plateau_threshold), \
            f32(cfg.plateau_factor)
        stop = f32(self.stop_lr)
        wrong, n = 0, len(hist["val"])
        expect = cfg.epochs
        for e, val in enumerate(hist["val"]):
            val = f32(val)
            if val < f32(best * shrink):
                best, bad = val, 0
            else:
                bad += 1
            if bad > cfg.patience:
                lr, bad = f32(lr * factor), 0
            wrong += int(f32(hist["lr"][e]) != lr)
            if lr < stop:
                expect = e + 1
                break
        return wrong + int(n != expect)

    def check(self, out):
        """The numbers compared, each with its readings: see ``PERF.md``.
        The first steps are judged by the median fold, as GSR-Net's: a
        last-bit difference can move a pool's top-k in one fold. The first
        gradient's gaps by leaf go to ``notes`` only: the worst leaf is
        one whose gradient is nought to rounding (the upsampler's bias
        under its row softmax), which the TF32 control reads no worse
        than sound runs."""
        dev = self.device
        common.strict_fp32()
        lr = torch.from_numpy(self.data["lr_train"]).to(dev)
        hr = torch.from_numpy(self.data["hr_train"]).to(dev)
        x = torch.from_numpy(ref.node_features(self.data["lr_train"],
                                               self.dim)).to(dev)
        p = float(self.pcfg.drop_p)
        gen = torch.Generator(device=dev).manual_seed(self.fold_seed)
        sites = ref.dropout_sites(self.n, self.dim, self.ks, self.heads)
        masks = [ref.keep_masks(gen, self.splits, sites, p)
                 for _ in range(STEPS)]
        mae_gap = val_gap = 0.0
        control = unmoved = counted = 0
        start = {"step_loss_gap": [], "update_norm_gap": []}
        self.notes = {"folds": []}
        for f, (tr, va) in enumerate(self.folds):
            va = torch.from_numpy(va).to(dev)
            Pb = {k: t.to(dev) for k, t in out["params"][f].items()}
            P0 = {k: t[f] for k, t in self.w0.items()}
            samples = [(lr[i:i + 1], x[i:i + 1], hr[i:i + 1])
                       for i in tr[:STEPS]]
            drops = [ref.dropper([mk[f] for mk in step], p)
                     for step in masks]
            losses, g1, P3 = ref.adamw_steps(
                P0, samples, drops, self.ks, self.heads, self.pcfg.lr,
                self.pcfg.weight_decay)
            loss_gaps = [abs(out["losses"][s][f] - v) / abs(v)
                         for s, v in enumerate(losses)]
            g_ref = {k: float(g.double().norm()) for k, g in g1.items()}
            d_ref = {k: float((P3[k] - P0[k]).double().norm()) for k in P0}
            med = float(np.median(list(g_ref.values())))
            # the leaves the reference's first gradient moves (a thousandth
            # of the median leaf's norm or more); the others' gradients are
            # nought to rounding
            moved = {k for k, v in g_ref.items() if v >= 1e-3 * med}
            g_all = common.norm_gaps(out["g1"][f], g_ref)
            g_moved = common.norm_gaps(out["g1"][f], g_ref, moved)
            d_moved = common.norm_gaps(out["dp"][f], d_ref, moved)
            worst = max(g_all, key=g_all.get)
            worst_moved = max(g_moved, key=g_moved.get)
            start["step_loss_gap"].append(max(loss_gaps))
            start["update_norm_gap"].append(max(d_moved.values()))
            self.notes["folds"].append(dict(
                loss_gaps=loss_gaps, grad_gap_all=g_all[worst],
                grad_worst_leaf=worst, grad_gap_moved=g_moved[worst_moved],
                grad_worst_moved_leaf=worst_moved,
                update_gap=max(d_moved.values()),
                left_out=sorted(set(g_ref) - moved),
                median_leaf_grad=med))
            counted += len(moved)
            unmoved += sum(int(torch.equal(Pb[k], P0[k])) for k in moved)
            loss, mae, _, _ = ref.losses_and_maes(
                Pb, lr[va], x[va], hr[va], self.ks, self.heads)
            mae, loss = float(mae.double().mean()), float(
                loss.double().mean())
            hist = out["histories"][f]
            mae_gap = max(mae_gap, abs(out["fold_maes"][f] - mae) / mae)
            val_gap = max(val_gap, abs(min(hist["val"]) - loss) / loss)
            control += self._replay_control(hist)
        lr_t = torch.from_numpy(self.data["lr_test"]).to(dev)
        x_t = torch.from_numpy(ref.node_features(self.data["lr_test"],
                                                 self.dim)).to(dev)
        P_last = {k: t.to(dev) for k, t in out["params"][-1].items()}
        prog = out["test_preds"].double()
        gaps, margins = [], []
        with torch.no_grad():
            for s in range(0, len(lr_t), 28):
                pred, _, _, margin = ref.forward(P_last, lr_t[s:s + 28],
                                                 x_t[s:s + 28], self.ks,
                                                 self.heads)
                pred = pred.double().cpu()
                gaps.append((prog[s:s + 28] - pred).abs().amax((-2, -1))
                            / pred.abs().amax((-2, -1)).clamp(min=1e-30))
                margins.append(margin.cpu())
        margin = torch.cat(margins).clamp(max=1.0).double()
        self.notes.update(start)
        self.notes.update(
            test_margin_quartiles=[float(q) for q in torch.quantile(
                margin, torch.tensor([0.05, 0.25, 0.5, 0.75],
                                     dtype=torch.float64))],
            test_worst_subject_gap=float(torch.cat(gaps).max()))
        values = {k: float(np.median(v)) for k, v in start.items()}
        values.update(fold_mae_gap=mae_gap, best_val_gap=val_gap,
                      control_mismatch=float(control),
                      test_pred_gap=float(torch.cat(gaps).median()),
                      unmoved_leaf_share=unmoved / max(counted, 1))
        return values

    # -- planted faults (the check's own readings and tests; never in a
    #    measured run), undone by ``close`` --------------------------------

    def _plant(self, fault):
        from fcsr_tpu_torch import pipelines
        from fcsr_tpu_torch.train import gat_loop
        if fault in ("frozen_step", "half_batch"):
            real = gat_loop._FoldTrainer._unfused_step
            which = "half" if fault == "half_batch" else "all"

            def step(tr, p0, m, v, i, scal):
                loss, p, m2, v2 = real(tr, p0, m, v, i, scal)
                keep = self._fold_mask(p0, fold_rows(p0.shape[0], which))
                return (loss, torch.where(keep, p0, p),
                        torch.where(keep, m, m2), torch.where(keep, v, v2))
            self._set(gat_loop._FoldTrainer, "_unfused_step", step)
        elif fault == "altered_answer":
            real = pipelines.predict_gat
            real_maes = pipelines._fold_maes_on_device

            def predict(*args, **kwargs):
                out = real(*args, **kwargs)
                return out + 1e-3 * out.abs().max()

            def maes(*args, **kwargs):
                return [m * (1 + 1e-3) for m in real_maes(*args, **kwargs)]
            self._set(pipelines, "predict_gat", predict)
            self._set(pipelines, "_fold_maes_on_device", maes)
        elif fault in ("wrong_lr", "no_decay"):
            # AdamW's update at ten times the learning rate, or without
            # its weight decay
            real_update = gat_loop.adamw_flat_update

            def update(g, p, m, v, t, lr, **kwargs):
                if fault == "wrong_lr":
                    lr = lr * 10.0
                else:
                    kwargs["wd"] = 0.0
                return real_update(g, p, m, v, t, lr, **kwargs)
            self._set(gat_loop, "adamw_flat_update", update)
        elif fault == "stale_schedule":
            real_control = gat_loop._run_device_control

            def control(tr, cfg, *args):
                return real_control(
                    tr, dataclasses.replace(cfg, plateau_factor=1.0), *args)
            self._set(gat_loop, "_run_device_control", control)
        else:
            raise ValueError(f"unknown fault {fault!r}")

