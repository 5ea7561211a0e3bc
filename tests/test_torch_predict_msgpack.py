"""`predict --params` on the JAX package's flax msgpack files, and the port's
own msgpack writer read by the JAX package (CPU)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization as fs

from fcsr_tpu import cli as jcli
from fcsr_tpu.iox import load_pytree as j_load_pytree
from fcsr_tpu.train import GSRTrainConfig as JCfg
from fcsr_tpu.train import init_gsr as j_init_gsr
from fcsr_tpu_torch import cli
from fcsr_tpu_torch.data import load_or_synthesize, write_kaggle_csvs
from fcsr_tpu_torch.iox import (flax_to_state, load_params, load_pytree,
                                save_pytree, save_state, state_to_flax)
from fcsr_tpu_torch.iox.checkpoint import is_msgpack
from fcsr_tpu_torch.models import GSRNet

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "outputs" / "gsr" / "gsr_net_trained.msgpack"


def _read_csv(path) -> np.ndarray:
    rows = Path(path).read_text().splitlines()
    assert rows[0] == "ID,Predicted"
    return np.array([float(r.split(",")[1]) for r in rows[1:]])


def test_load_params_reads_the_jax_file():
    got = load_params(str(FIXTURE))
    want = flax_to_state(fs.msgpack_restore(FIXTURE.read_bytes()))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["layer.weights"].shape == (268, 160)


@pytest.fixture(scope="module")
def four_subjects(tmp_path_factory):
    """Kaggle CSVs holding the teacher set's first 4 test subjects (and 2
    training pairs) at full width (160 -> 268)."""
    d = tmp_path_factory.mktemp("csv4")
    data = load_or_synthesize(None, device="cpu")
    write_kaggle_csvs({"lr_train": data["lr_train"][:2],
                       "hr_train": data["hr_train"][:2],
                       "lr_test": data["lr_test"][:4]}, str(d))
    return d


@pytest.mark.parametrize("ordering", ["rowmajor", "colmajor"])
def test_predict_msgpack_matches_jax(four_subjects, tmp_path, ordering):
    """`python -m fcsr_tpu_torch predict --params <the JAX file> --device
    cpu` against `python -m fcsr_tpu predict` (init_gsr + load_pytree +
    predict_gsr) on the same CSVs: within 1e-4 (the full-width GSR-Net
    forward's tolerance)."""
    got_csv, want_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    common = ["--params", str(FIXTURE), "--data-dir", str(four_subjects),
              "--ordering", ordering]
    assert cli.main(["predict", *common, "--out", str(got_csv),
                     "--device", "cpu"]) == 0
    assert jcli.main(["predict", *common, "--out", str(want_csv)]) == 0
    got, want = _read_csv(got_csv), _read_csv(want_csv)
    assert got.shape == want.shape == (4 * 268 * 267 // 2,)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert float(np.abs(got - want).max()) <= 1e-4


def test_port_written_state_loads_in_the_jax_package(tmp_path):
    """A GSR-Net state written by the port (state_to_flax + save_pytree)
    restores into the JAX package's template through its load_pytree,
    every leaf equal."""
    cfg = JCfg(lr_dim=20, hr_dim=32, hidden_dim=32)
    _, template, _, _ = j_init_gsr(cfg, jax.random.PRNGKey(0))
    model = GSRNet(cfg.ks, 20, 32, 32, device="cpu", seed=3)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    path = str(tmp_path / "port.msgpack")
    save_pytree(state_to_flax(state), path)
    restored = j_load_pytree(template, path)
    back = flax_to_state(jax.tree_util.tree_map(np.asarray, restored))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    # and the port reads its own file back
    mine = load_params(path)
    for k in state:
        np.testing.assert_array_equal(mine[k], state[k])
    assert load_pytree(path)["params"].keys() == {"layer", "net", "gc1",
                                                  "gc2"}


def test_npz_files_still_load(tmp_path):
    model = GSRNet((0.9, 0.7, 0.6, 0.5), 20, 32, 32, device="cpu", seed=1)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    path = str(tmp_path / "state.npz")
    save_state(state, path)
    assert not is_msgpack(path)
    got = load_params(path)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    assert is_msgpack(str(FIXTURE))
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="neither"):
        load_params(str(junk))
    other = tmp_path / "other.msgpack"
    save_pytree({"params": {"w": torch.ones(2)}}, str(other))
    with pytest.raises(ValueError, match="no GSR-Net"):
        load_params(str(other))
