"""The port's evaluation pass (``fcsr_tpu_torch/evalx/report.py``) against
the JAX package's on the same seeded stacks, on the CPU, and the
``evaluate`` command of both command lines.

Tolerances: the device backend's topology metrics in float64 within 1e-10
of JAX's float64; in float32 within 3e-5 of JAX's float32, and of the
port's float64 on the JAX package's own case for that bound; MAE, PCC and JSD
bit-equal (the same host numpy / scipy calls); the networkx backend
bit-equal to JAX's; the device backend within rtol 2e-4 of networkx (the
JAX package's bound). The result does not depend on the chunk size.
"""

import sys

import numpy as np
import pytest
import torch

from fcsr_tpu.evalx import report as JR
from fcsr_tpu_torch import cli
from fcsr_tpu_torch.evalx import (evaluate_metrics, evaluate_pair_stacks,
                                  print_metrics)
from fcsr_tpu_torch.evalx import report as TR
from tests.conftest import random_symmetric

N = 30
TOPO = ("mae_betweenness", "mae_eigenvector", "mae_pagerank",
        "mae_core_periphery", "kl_weights")
HOST = ("mae", "pcc", "js_distance")
# the report's lines: each key's label, in the reference's order
ORDER = ("mae", "pcc", "js_distance", "kl_weights", "mae_betweenness",
         "mae_eigenvector", "mae_pagerank", "mae_core_periphery")
LABELS = ("MAE: ", "PCC: ", "Jensen-Shannon Distance: ",
          "Average KL Divergence on weight distributions: ",
          "Average MAE betweenness centrality: ",
          "Average MAE eigenvector centrality: ",
          "Average MAE PageRank centrality: ",
          "Average MAE core-periphery structure: ")


def _stacks(kind, seed=0, b=5):
    rng = np.random.default_rng(seed)
    gt = np.stack([random_symmetric(rng, N, density=0.6) for _ in range(b)])
    if kind == "random":
        noise = rng.normal(0, 0.05, gt.shape)
        pred = np.clip(gt + (noise + noise.transpose(0, 2, 1)) / 2, 0, 1)
        for m in pred:
            np.fill_diagonal(m, 0.0)
        return gt, pred.astype(np.float32)
    if kind == "zero_pred":                  # a collapsed prediction
        return gt, np.zeros_like(gt)
    if kind == "tiny_weights":
        # an untrained model's predictions: many near-zero weights, so
        # shortest paths run through many short edges
        u = rng.random(gt.shape) ** 8
        pred = np.triu(u, 1) + np.triu(u, 1).transpose(0, 2, 1)
        return gt, pred.astype(np.float32)
    # one edgeless ground truth and one prediction with a single edge
    pred = np.stack([random_symmetric(rng, N, density=0.9)
                     for _ in range(b)])
    gt[1] = 0.0
    pred[2] = 0.0
    pred[2, 3, 7] = pred[2, 7, 3] = 0.5
    return gt, pred


def _same(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("kind", ["random", "zero_pred", "edgeless",
                                  "tiny_weights"])
def test_device_backend_matches_jax(kind):
    """On near-zero weights the float32 tie rule (1e-5 relative) joins
    shortest paths that float64 keeps apart: JAX's float32 betweenness
    then lies far from its float64, and the port's float32 follows JAX's."""
    gt, pred = _stacks(kind)
    ours = {p: evaluate_pair_stacks(gt, pred, seed=7, precision=p,
                                    device="cpu")
            for p in ("float64", "float32")}
    theirs = {p: JR.evaluate_pair_stacks(gt, pred, seed=7, precision=p)
              for p in ("float64", "float32")}
    for p in ("float64", "float32"):
        assert set(ours[p]) == set(theirs[p]) == set(TOPO + HOST)
        for k in HOST:
            assert _same(ours[p][k], theirs[p][k]), (p, k)
    for k in TOPO:
        assert abs(ours["float64"][k] - theirs["float64"][k]) <= 1e-10, k
        assert abs(ours["float32"][k] - theirs["float32"][k]) <= 3e-5, k
    if kind == "tiny_weights":
        gap = theirs["float32"]["mae_betweenness"] \
            - theirs["float64"]["mae_betweenness"]
        assert abs(gap) > 3e-5


def test_float32_within_3e5_of_float64():
    """The JAX package's own case for its float32 bound (60 dense nodes,
    small symmetric noise). On sparser stacks with weights clipped to 0 and
    1 the float32 betweenness moves further, in JAX's float32 as in the
    port's (its 1e-5 tie rule joins near-tied shortest paths); there the
    port is held to JAX's float32 above."""
    rng = np.random.default_rng(11)
    gt = rng.random((6, 60, 60))
    gt = (gt + gt.transpose(0, 2, 1)) / 2
    noise = rng.normal(0, 0.02, gt.shape)
    pred = np.clip(gt + (noise + noise.transpose(0, 2, 1)) / 2, 0, 1)
    for m in (*gt, *pred):
        np.fill_diagonal(m, 0.0)
    m64 = evaluate_pair_stacks(gt, pred, device="cpu")
    m32 = evaluate_pair_stacks(gt, pred, precision="float32", device="cpu")
    for k in TOPO:
        assert abs(m64[k] - m32[k]) < 3e-5, (k, m64[k], m32[k])
    for k in HOST:
        assert m64[k] == m32[k]


@pytest.mark.parametrize("samples", [1, 3])
def test_result_does_not_depend_on_the_chunk(samples, monkeypatch):
    """Chunks of 1 and 3 samples in float64 (2 and 6 in float32) against
    the whole stack of 7 in one chunk, bit for bit."""
    gt, pred = _stacks("random", seed=1, b=7)
    whole = {p: evaluate_pair_stacks(gt, pred, precision=p, device="cpu")
             for p in ("float64", "float32")}
    # a float64 sample's betweenness temporary: pred and gt, 10 pivots
    monkeypatch.setattr(TR, "_CHUNK_BYTES", samples * 2 * 10 * N * N * 8)
    sizes = [m for _, _, m, _ in TR._device_chunks(gt, pred, 42,
                                                    device="cpu")]
    assert sizes == [samples] * (7 // samples) + [7 % samples] * (
        7 % samples > 0)
    for p in ("float64", "float32"):
        assert evaluate_pair_stacks(gt, pred, precision=p,
                                    device="cpu") == whole[p], p


def test_inputs_may_be_tensors():
    gt, pred = _stacks("random", seed=2, b=2)
    want = evaluate_pair_stacks(gt, pred, device="cpu")
    assert evaluate_pair_stacks(torch.from_numpy(gt), torch.from_numpy(pred),
                                device="cpu") == want
    got = evaluate_metrics(lambda lr: torch.from_numpy(pred), gt[:, :8, :8],
                           gt, write_file=False, verbose=False, device="cpu")
    assert got == want


def test_networkx_backend_matches_jax_and_device():
    gt, pred = _stacks("random", seed=3, b=3)
    ours = evaluate_pair_stacks(gt, pred, backend="networkx", seed=5)
    theirs = JR.evaluate_pair_stacks(gt, pred, backend="networkx", seed=5)
    assert ours == theirs
    dev = evaluate_pair_stacks(gt, pred, seed=5, device="cpu")
    for k in ours:
        np.testing.assert_allclose(dev[k], ours[k], rtol=2e-4, err_msg=k)


def test_networkx_backend_never_falls_back(monkeypatch):
    gt, pred = _stacks("random", seed=4, b=2)
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="networkx"):
        evaluate_pair_stacks(gt, pred, backend="networkx")
    with pytest.raises(ImportError, match="networkx"):
        TR.require_networkx()


def test_non_converging_eigenvector_raises_as_jax_does():
    """(I + A) with A = -2 (J - I) has its largest eigenvalue in size at
    -57: the iterate flips sign every step; networkx raises there, and so
    do both device backends."""
    gt, pred = _stacks("random", seed=5, b=2)
    pred[1] = -2.0 * (np.ones((N, N)) - np.eye(N))
    with pytest.raises(RuntimeError, match="eigenvector centrality"):
        evaluate_pair_stacks(gt, pred, device="cpu")
    with pytest.raises(RuntimeError, match="eigenvector centrality"):
        JR.evaluate_pair_stacks(gt, pred)


def test_bad_arguments_and_no_card_raise():
    gt, pred = _stacks("random", seed=6, b=1)
    with pytest.raises(ValueError, match="unknown precision"):
        evaluate_pair_stacks(gt, pred, precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        evaluate_pair_stacks(gt, pred, backend="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate_pair_stacks(gt, pred)


def _read_results(path):
    out = []
    for line in path.read_text().splitlines():
        label, _, value = line.rpartition(" ")
        out.append((label + " ", float(value)))
    return out


def test_print_metrics_writes_the_jax_file(tmp_path, capsys):
    gt, pred = _stacks("random", seed=8, b=3)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    m = print_metrics(gt, pred, fold_i=3, out_dir=str(tmp_path / "t"),
                      device="cpu")
    JR.print_metrics(gt, pred, fold_i=3, out_dir=str(tmp_path / "j"))
    printed = capsys.readouterr().out.splitlines()
    ours = _read_results(tmp_path / "t" / "results_fold_3.txt")
    theirs = _read_results(tmp_path / "j" / "results_fold_3.txt")
    assert [lab for lab, _ in ours] == [lab for lab, _ in theirs] \
        == list(LABELS)
    for (lab, a), (_, b) in zip(ours, theirs):
        assert abs(a - b) <= 1e-10 and (a == b or "Average" in lab), lab
    assert printed[:8] == [f"{lab} {m[k]}" for lab, k in zip(LABELS, ORDER)]
    assert [v for _, v in ours] == [m[k] for k in ORDER]


def test_cli_evaluate_matches_jax_cli(tmp_path, capsys):
    from fcsr_tpu import cli as j_cli
    gt, pred = _stacks("random", seed=9, b=3)
    np.savez(tmp_path / "gt.npz", gt=gt)
    np.save(tmp_path / "pred.npy", pred)
    args = ["evaluate", "--gt", str(tmp_path / "gt.npz"), "--pred",
            str(tmp_path / "pred.npy"), "--fold", "2"]
    for pkg, main, extra in (("t", cli.main, ["--device", "cpu"]),
                             ("j", j_cli.main, [])):
        (tmp_path / pkg).mkdir()
        assert main(args + ["--out-dir", str(tmp_path / pkg)] + extra) == 0
    capsys.readouterr()
    ours = _read_results(tmp_path / "t" / "results_fold_2.txt")
    theirs = _read_results(tmp_path / "j" / "results_fold_2.txt")
    assert [lab for lab, _ in ours] == [lab for lab, _ in theirs]
    for (lab, a), (_, b) in zip(ours, theirs):
        assert abs(a - b) <= 1e-10, lab
    assert ours[:3] == theirs[:3]                   # MAE, PCC, JSD: bit-equal
    # the networkx backend through the command line: the same file as JAX's
    for pkg, main, extra in (("tn", cli.main, []), ("jn", j_cli.main, [])):
        (tmp_path / pkg).mkdir()
        assert main(args + ["--backend", "networkx", "--out-dir",
                            str(tmp_path / pkg)] + extra) == 0
    assert (tmp_path / "tn" / "results_fold_2.txt").read_text() \
        == (tmp_path / "jn" / "results_fold_2.txt").read_text()
