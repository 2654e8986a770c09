"""The .npz checkpoint format and the evaluation report's table, the latter
against the ``tabulate`` package kept as a test-only oracle."""

import json
import logging
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tomosar2height_jax.infer.evaluator import print_statistics, tabulate
from tomosar2height_jax.train.checkpoint import CheckpointIO, SCALARS_KEY
from tomosar2height_jax.train.schedule import build_scheduler
from tomosar2height_jax.train.trainer import make_optimizer


def _state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"params": {"enc": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                                 "bias": np.zeros(4, np.float32)},
                         "head": {"scale": rng.normal(size=(2,)).astype(np.float32)}}}
    opt = make_optimizer(optimize_every=4).init(jax.tree.map(jnp.asarray, params))
    return params, jax.device_get(opt)


def _scheduler():
    return build_scheduler({
        "learning_rate": 1e-4,
        "scheduler": {"type": "CyclicLR", "kwargs": {
            "base_lr": 1e-4, "max_lr": 5e-4, "mode": "triangular2", "gamma": 1.0,
            "step_size_up": 5, "step_size_down": 5}}})


def test_npz_round_trip(tmp_path):
    params, opt = _state(0)
    sched = _scheduler()
    for _ in range(3):
        sched.step()
    path = str(tmp_path / "model_3.ckpt")
    CheckpointIO(str(tmp_path), model=params, optimizer=opt, scheduler=sched).save(
        path, n_iter=3, loss_val_best=float("inf"), stream_pos=[1, 2],
        training_time=np.float64(1.5))
    # a plain .npz: every leaf an array, the scalars one JSON string, no pickle
    with np.load(path, allow_pickle=False) as npz:
        assert "model/params/enc/kernel" in npz.files
        scalars = json.loads(str(npz[SCALARS_KEY]))
    assert scalars["n_iter"] == 3 and scalars["stream_pos"] == [1, 2]
    assert zipfile.is_zipfile(path)

    params2, opt2 = _state(1)
    sched2 = _scheduler()
    io = CheckpointIO(str(tmp_path), model=params2, optimizer=opt2, scheduler=sched2)
    meta = io.load(path)
    assert meta == {"n_iter": 3, "loss_val_best": float("inf"), "stream_pos": [1, 2],
                    "training_time": 1.5}
    for a, b in zip(jax.tree.leaves(io.module_dict["model"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert (jax.tree.structure(io.module_dict["optimizer"]) == jax.tree.structure(opt))
    for a, b in zip(jax.tree.leaves(io.module_dict["optimizer"]), jax.tree.leaves(opt)):
        np.testing.assert_array_equal(a, b)
    assert sched2.lr == sched.lr


def test_mismatched_module_is_left_alone(tmp_path, caplog):
    params, _ = _state(0)
    path = str(tmp_path / "m.ckpt")
    CheckpointIO(str(tmp_path), model=params).save(path, n_iter=1)
    wrong = {"params": {"enc": {"kernel": np.zeros((5, 4), np.float32)}}}
    io = CheckpointIO(str(tmp_path), model=wrong, optimizer={"mu": np.zeros(2)})
    with caplog.at_level(logging.WARNING):
        io.load(path)
    assert io.module_dict["model"] is wrong  # shape mismatch: kept, warned
    assert "Could not load model" in caplog.text
    assert "Could not find optimizer" in caplog.text


HEADER = ["Type", "MAE[m]", "RMSE[m]", "MedAE[m]", "Max[m]", "Min[m]", "Median[m]",
          "NMAD[m]", "#Pixels"]


def _rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for name in ("Overall", "Terrain", "Non Residential"):
        row = [name] + [float(rng.normal() * 10.0 ** rng.integers(-3, 4)) for _ in range(7)]
        rows.append(row + [int(rng.integers(0, 10 ** 7))])
    if seed % 2:
        rows[1][2] = float("nan")
    if seed % 3 == 0:
        rows[2][1:] = [None] * 8  # an empty class
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_table_matches_tabulate(seed):
    tab = pytest.importorskip("tabulate")
    rows = _rows(seed)
    assert tabulate(rows, HEADER) == tab.tabulate(rows, headers=HEADER, tablefmt="simple",
                                                  floatfmt=".4f")


def test_report_layout(tmp_path):
    stats = {k: {"MAE": 1.0, "RMSE": 2.0, "abs_median": 0.5, "max": 9.0, "min": -3.0,
                 "median": 0.1, "NMAD": 0.7, "n_pixel": 100}
             for k in ("overall", "terrain", "building", "roof_flat")}
    path = tmp_path / "eval.txt"
    text = print_statistics(stats, "run-iter1", save_to=str(path), has_binary=True)
    assert path.read_text() == text
    lines = text.splitlines()
    assert "Binary Building Classification:" in lines
    i = lines.index("Binary Building Classification:")
    assert lines[i + 1].split() == HEADER
    assert lines[i + 3].split()[0] == "Overall" and lines[i + 3].endswith("100")
    assert any(line.startswith("Roof Flat") for line in lines)
