"""chip_smoke.py on the CPU: its phase functions at tiny widths, and its
refusal to report a result without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from __graft_entry__ import _flagship_model, build_synthetic_city  # noqa: E402

# the tiny network and city the CPU can train and serve in seconds
TINY = [
    "dataset.patch_size=[128,128]",
    "dataset.sliding_window.val_strip=[256,256]",
    "dataset.sliding_window.vis_strip=[128,128]",
    "dataset.sliding_window.test_strip=[128,128]",
    "dataset.points.bucket_sizes=[2048]",
    "dataset.points.train_bucket=2048",
    "model.encoder_kwargs.plane_resolution=32",
    "model.encoder_kwargs.hidden_dim=8",
    "model.encoder_kwargs.feature_dim=8",
    "model.encoder_kwargs.unet_kwargs.depth=3",
    "model.encoder_kwargs.unet_kwargs.start_filts=8",
    "model.decoder_pixel_kwargs.hidden_dim=8",
    "model.decoder_pixel_kwargs.output_size=128",
    "model.remat=false",
    "training.batch_size=2",
    "training.optimize_every=2",
    "training.val_batch_size=2",
    "training.random_dataset_length=8",
    "dataloader.prefetch=0",
]


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_forward_parity_phase():
    import jax

    cpu = jax.devices("cpu")[0]
    errors = chip_smoke.forward_parity(_flagship_model(tiny=True), 2, 512, cpu, cpu)
    assert errors["scale_m"] > 0
    assert set(chip_smoke.FORWARD_RTOL) <= set(errors)
    assert errors["f32_highest"]["max_m"] <= errors["f32_highest"]["tol_m"]
    chip_smoke.check_parity(errors)


def test_train_and_serve_phases(tmp_path, capsys):
    root = str(tmp_path)
    overrides = chip_smoke.train_overrides(root, "cpu", TINY)
    build_synthetic_city(root, 0.055, overrides)
    trained = chip_smoke.phase_train(overrides)
    assert trained["n_iter"] == 2 and os.path.exists(trained["ckpt"])
    chip_smoke.phase_serve(overrides, trained)
    out = capsys.readouterr().out
    assert "[c] train: 2 optimizer steps" in out and "[d] serve:" in out


def test_four_device_phase_on_virtual_devices(tmp_path, capsys):
    """The --four path on four of the test session's virtual CPU devices."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the 8-device virtual mesh")
    model = _flagship_model(tiny=True)
    chip_smoke.four_devices(str(tmp_path), model, 4, 512, [
        "dataset.patch_size=[64,64]",
        "dataset.sliding_window.vis_strip=[32,32]",
        "dataset.points.bucket_sizes=[1024]",
        "dataset.points.train_bucket=1024",
    ])
    out = capsys.readouterr().out
    assert "[4a] DP train window on 4 devices" in out
    assert out.count("[4b] sharded generate_dsm") == 2
