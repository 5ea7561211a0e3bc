"""CSV ingest of the port against the JAX package: one Kaggle-schema CSV
set, written once, read by both (CPU). Also the device-ingest functions,
the checkpoint archive and the submission writer on their own."""

import os

import numpy as np
import pytest
import torch

from fcsr_tpu.data import io as j_io
from fcsr_tpu.data.device_pipeline import load_dataset_device as j_load_dev
from fcsr_tpu_torch.core import normalize_adj_batch
from fcsr_tpu_torch.data import (ingest_vectors_to_device, load_csv_vectors,
                                 load_dataset, load_dataset_device,
                                 load_or_synthesize, matrix_size_for,
                                 synthesize_teacher_connectomes,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.data import io as t_io
from fcsr_tpu_torch.iox import (load_arrays, load_state, save_arrays,
                                save_prediction, save_state,
                                submission_frame)
from fcsr_tpu_torch.native import fast_csv_available

NAMES = ("lr_train", "hr_train", "lr_test")


@pytest.fixture(scope="module")
def teacher():
    lr, hr, lt = synthesize_teacher_connectomes(6, lr_dim=20, hr_dim=32,
                                                seed=1, n_test=3)
    return {"lr_train": lr, "hr_train": hr, "lr_test": lt}


@pytest.fixture(scope="module")
def csv_dir(teacher, tmp_path_factory):
    """The set both packages read, written by the JAX package's writer
    with 2% NaN cells."""
    d = tmp_path_factory.mktemp("kaggle")
    j_io.write_kaggle_csvs(teacher, str(d), nan_frac=0.02, seed=3)
    return str(d)


def test_writer_writes_the_same_files_as_jax(teacher, csv_dir, tmp_path):
    write_kaggle_csvs(teacher, str(tmp_path), nan_frac=0.02, seed=3)
    for name in NAMES:
        with open(os.path.join(csv_dir, f"{name}.csv")) as a, \
                open(tmp_path / f"{name}.csv") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_csv_vectors_equal_jax(csv_dir, name, native):
    if native and not fast_csv_available():
        pytest.skip("no g++: the native parser cannot be built")
    path = os.path.join(csv_dir, f"{name}.csv")
    got = load_csv_vectors(path, native=native)
    want = j_io.load_csv_vectors(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > 0 and not np.isnan(got).any()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("first", ["", "Unnamed: 0", "ID", '"ID"', "v0"])
def test_header_rule_and_empty_cells(tmp_path, first, native):
    """A leading ``"" | "Unnamed: 0" | "ID"`` column is dropped, any other
    first column is data; empty and NaN cells become 0."""
    if native and not fast_csv_available():
        pytest.skip("no g++: the native parser cannot be built")
    path = tmp_path / "v.csv"
    path.write_text(f"{first},a,b\n1,0.25,\n2,nan,0.5\n\n3,NaN,1e-3\n")
    got = load_csv_vectors(str(path), native=native)
    body = np.array([[0.25, 0], [0, 0.5], [0, 1e-3]], np.float32)
    if first == "v0":
        body = np.concatenate([np.array([[1], [2], [3]], np.float32), body],
                              axis=1)
    np.testing.assert_array_equal(got, body)


def test_native_parser_builds_under_build_dir():
    if not fast_csv_available():
        pytest.skip("no g++: the native parser cannot be built")
    from fcsr_tpu_torch.native import csv_reader
    path = csv_reader._lib_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(t_io.__file__)))
    assert path.exists()
    assert str(path).startswith(os.path.join(os.path.dirname(repo), "build",
                                             "fcsr_tpu_torch"))
    src_dir = os.path.dirname(csv_reader.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_load_dataset_equals_jax(teacher, csv_dir):
    got = load_dataset(csv_dir, cache=False, device="cpu")
    want = j_io.load_dataset(csv_dir, cache=False)
    assert sorted(got) == sorted(want) == sorted(NAMES)
    for name in NAMES:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
        # exact where no NaN was written, 0 where one was
        changed = got[name] != teacher[name]
        assert changed.any() and (got[name][changed] == 0).all()
        np.testing.assert_array_equal(got[name],
                                      got[name].transpose(0, 2, 1))


def test_load_or_synthesize_takes_the_csv_branch(csv_dir):
    got = load_or_synthesize(csv_dir, device="cpu")
    want = j_io.load_or_synthesize(csv_dir)
    for name in NAMES:
        np.testing.assert_array_equal(got[name], want[name])
    assert got["hr_train"].shape == (6, 32, 32)


@pytest.mark.parametrize("missing", ["hr_train.csv", "lr_test.csv"])
def test_partial_csv_set_raises_naming_the_missing_file(teacher, tmp_path,
                                                        missing):
    write_kaggle_csvs(teacher, str(tmp_path), nan_frac=0.0)
    os.remove(tmp_path / missing)
    with pytest.raises(FileNotFoundError, match=f"missing {missing}"):
        load_dataset(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match=f"missing {missing}"):
        j_io.load_dataset(str(tmp_path))


def test_stale_cache_is_regenerated_not_served(teacher, tmp_path):
    d = str(tmp_path)
    write_kaggle_csvs(teacher, d, nan_frac=0.0)
    first = load_dataset(d, device="cpu")
    cache = tmp_path / "fcsr_cache.npz"
    assert cache.exists()
    np.testing.assert_array_equal(first["lr_train"], teacher["lr_train"])
    # a fresh cache is served: poison it under the current fingerprint
    fp = t_io._csv_fingerprint(d)
    poisoned = {k: np.zeros_like(v) for k, v in first.items()}
    np.savez_compressed(cache, _fingerprint=fp, **poisoned)
    assert not load_dataset(d, device="cpu")["lr_train"].any()
    # an edited CSV changes the fingerprint: the cache is rebuilt
    other = dict(teacher, lr_train=teacher["lr_train"][:4])
    write_kaggle_csvs(other, d, nan_frac=0.0)
    assert t_io._csv_fingerprint(d) != fp
    again = load_dataset(d, device="cpu")
    np.testing.assert_array_equal(again["lr_train"], teacher["lr_train"][:4])
    # the JAX package reads the port's cache file as its own
    np.testing.assert_array_equal(j_io.load_dataset(d)["lr_train"],
                                  again["lr_train"])


@pytest.mark.parametrize("vec_len,n", [(12720, 160), (35778, 268), (1, 2),
                                       (190, 20)])
def test_matrix_size_for(vec_len, n):
    assert matrix_size_for(vec_len) == n == j_io.matrix_size_for(vec_len)
    with pytest.raises(ValueError, match="strict-upper-triangle"):
        matrix_size_for(vec_len + 1)


@pytest.mark.parametrize("normalize_lr", [False, True])
def test_device_pipeline_equals_jax(csv_dir, normalize_lr):
    got = load_dataset_device(csv_dir, normalize_lr=normalize_lr,
                              device="cpu")
    want = j_load_dev(csv_dir, normalize_lr=normalize_lr, interpret=True)
    host = load_dataset(csv_dir, cache=False, device="cpu")
    for name in NAMES:
        assert isinstance(got[name], torch.Tensor)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-6 if normalize_lr else 0, rtol=0)
    np.testing.assert_array_equal(got["hr_train"].numpy(), host["hr_train"])
    lr = normalize_adj_batch(host["lr_test"]) if normalize_lr \
        else torch.from_numpy(host["lr_test"])
    assert torch.equal(got["lr_test"], lr)
    vecs = load_csv_vectors(os.path.join(csv_dir, "lr_test.csv"))
    assert torch.equal(ingest_vectors_to_device(vecs, 20, device="cpu"),
                       torch.from_numpy(host["lr_test"]))


def test_state_and_array_archives_round_trip(tmp_path):
    from fcsr_tpu_torch.models import GSRNet
    model = GSRNet((0.9, 0.7), 20, 32, 32, device="cpu", seed=4)
    path = str(tmp_path / "state.npz")
    save_state(model.state_dict(), path)
    state = load_state(path)
    assert sorted(state) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(state[k], v.numpy())
    assert os.listdir(tmp_path) == ["state.npz"]       # no temp file left
    save_arrays(path, a=np.arange(3), tag=np.str_("x"))
    blob = load_arrays(path)
    assert blob["a"].tolist() == [0, 1, 2] and str(blob["tag"]) == "x"
    with pytest.raises(ValueError, match="no GSR-Net state"):
        load_state(path)


@pytest.mark.parametrize("ordering", ["colmajor", "rowmajor"])
def test_submission_file_parses_back_to_the_same_float32(rng, tmp_path,
                                                         ordering):
    from fcsr_tpu.iox.submission import _vectorize as j_vectorize
    preds = rng.standard_normal((3, 9, 9)).astype(np.float32) * 1e-3
    preds[0, 0, 1] = np.float32(1 / 3)
    preds[0, 1, 2] = 1e-30
    path = tmp_path / "sub.csv"
    flat = save_prediction(torch.from_numpy(preds), str(path), ordering)
    ids, vals = submission_frame(preds, ordering)
    np.testing.assert_array_equal(flat, vals)
    np.testing.assert_array_equal(
        flat, np.asarray(j_vectorize(preds, ordering)).reshape(-1))
    lines = path.read_text().splitlines()
    assert lines[0] == "ID,Predicted" and len(lines) == 1 + 3 * 36
    table = np.array([ln.split(",") for ln in lines[1:]])
    np.testing.assert_array_equal(table[:, 0].astype(np.int64), ids)
    assert ids[0] == 1 and ids[-1] == 108 and ids.dtype == np.int64
    np.testing.assert_array_equal(table[:, 1].astype(np.float64)
                                  .astype(np.float32), flat)
    with pytest.raises(ValueError, match="unknown ordering"):
        save_prediction(preds, str(path), "diagonal")


@pytest.mark.parametrize("ordering", ["colmajor", "rowmajor"])
def test_nan_and_inf_predictions_are_written_as_jax_writes_them(
        rng, tmp_path, ordering):
    """A NaN prediction is an empty ``Predicted`` field and ±inf is
    ``inf`` / ``-inf``, as pandas' ``to_csv`` writes them for
    ``fcsr_tpu.iox.save_prediction``. The two files are compared line by
    line as parsed values and NaN positions, not as bytes: the port writes
    9 significant digits, pandas the shortest float32 repr."""
    from fcsr_tpu.iox import save_prediction as j_save_prediction
    preds = rng.standard_normal((2, 9, 9)).astype(np.float32)
    for f, i, j, v in ((0, 0, 1, np.nan), (0, 3, 5, np.inf),
                       (1, 2, 7, -np.inf), (1, 4, 6, np.nan)):
        preds[f, i, j] = preds[f, j, i] = v
    t_path, j_path = tmp_path / "port.csv", tmp_path / "jax.csv"
    save_prediction(torch.from_numpy(preds), str(t_path), ordering)
    j_save_prediction(preds, str(j_path), ordering)
    t_lines = t_path.read_text().splitlines()
    j_lines = j_path.read_text().splitlines()
    assert t_lines[0] == j_lines[0] == "ID,Predicted"
    assert len(t_lines) == len(j_lines) == 1 + 2 * 36
    fields = {"": 0, "inf": 0, "-inf": 0}
    for t_line, j_line in zip(t_lines[1:], j_lines[1:]):
        (t_id, t_val), (j_id, j_val) = t_line.split(","), j_line.split(",")
        assert t_id == j_id
        if not np.isfinite(float(j_val or "nan")):
            assert t_val == j_val
            fields[j_val] += 1
        else:
            assert np.float32(t_val) == np.float32(j_val)
    assert fields == {"": 2, "inf": 1, "-inf": 1}
