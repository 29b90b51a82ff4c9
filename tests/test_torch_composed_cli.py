"""The CLI on a composed mesh (ROADMAP 17.5a): ``--multihost`` with
``mesh: {data: 2, spatial: 2}`` on 2 gloo CPU ranks, each banding its
frames over two CPU "devices" (``RTSDS_CPU_DEVICES=2``), trains
BiSeNet-R18 one epoch of 4 steps on colour-coded labels (K2's plain
version in the transform, before banding) with SGD (lr 1e-4, momentum
0.9) and validates (K1's per band, summed over the bands and the data
group).  Both ranks report the same history, whose loss is the
one-process run's (no mesh, in a child with one torch thread as each
rank has) at rtol 1e-4: the port's BatchNorms on bands and over ranks sum
in float32, ATen's CPU batch norm in float64, and four float32 steps of
a random BiSeNet amplify that (the runs read 2e-5 apart in the loss, a
``{data: 2}`` run without bands as far; at lr 0 all agree to 2e-7; the
float64 steps are held at 1e-9 in test_torch_composed.py).  The
checkpoint rank 0 writes holds the whole tensors: ``--validate_only`` on
the same composed mesh restores it and reports the run's mIoU exactly,
and ``Predictor.from_checkpoint`` serves it.  A run of several ranks
with too few CPU devices for its bands exits.

Where a process's bands live (``parallel/mesh.py:band_devices``, no card
touched: the GPU count is stubbed): local rank r on ``cuda:r*S`` to
``cuda:r*S+S-1``, every band on ``cuda:0`` on a box with one GPU, too few
GPUs raise; the composed job mesh of several processes puts this rank's
band devices at every (data, spatial, model) entry of their spatial
index, and ``Mesh.axis_devices`` reads them back.
"""

import numpy as np
import pytest
import torch

from rtsds_tpu_torch.parallel.launch import run_ranks
from test_torch_composed import BANDS_ENV, TIMEOUT_S

SIZE = (32, 64)


def cli_worker(rank, world, argv):
    from rtsds_tpu_torch import cli

    return cli.main([*argv, "--multihost"] if world > 1 else argv)


def _config(tmp_path, name: str, mesh: str) -> str:
    path = tmp_path / f"{name}.yaml"
    path.write_text(f"""
device: cpu
{mesh}
model:
  bisenet: {{optimizer: {{name: SGD, lr: 0.0001}}}}
data:
  cityscapes: {{image_size: "32, 64", batch_size: 4, num_workers: 1}}
  gta5_modified: {{image_size: "32, 64", batch_size: 4, num_workers: 1,
                  decode_label_colors: true}}
training:
  segmentation: {{epochs: 1, do_validation: 1}}
callbacks:
  model_checkpoint: {{save_dir: "{tmp_path}/{name}", save_name: "m",
                     save_best: false, save_freq: 1}}
""")
    return str(path)


def test_cli_trains_on_data_x_spatial_and_its_checkpoint_serves(tmp_path):
    from rtsds_tpu_torch.serve import Predictor

    argv = ["--synthetic", "--dataset", "gta5"]
    composed = run_ranks(cli_worker, 2, (["--config", _config(
        tmp_path, "composed", "mesh: {data: 2, spatial: 2}"), *argv],),
        backend=None, timeout_s=TIMEOUT_S, env=BANDS_ENV)
    one = run_ranks(cli_worker, 1, (["--config", _config(
        tmp_path, "one", ""), *argv],), backend=None,
        timeout_s=TIMEOUT_S)[0]
    assert composed[0] == composed[1]
    assert len(one) == len(composed[0]) == 1
    np.testing.assert_allclose(composed[0][0]["train_loss"],
                               one[0]["train_loss"], rtol=1e-4)
    a = torch.load(tmp_path / "composed" / "m" / "epoch_0.pt",
                   weights_only=True)["model"]["model"]
    b = torch.load(tmp_path / "one" / "m" / "epoch_0.pt",
                   weights_only=True)["model"]["model"]
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        assert a[k].shape == v.shape, k
    restored = run_ranks(cli_worker, 2, (["--config", _config(
        tmp_path, "composed", "mesh: {data: 2, spatial: 2}"), *argv,
        "--validate_only"],), backend=None, timeout_s=TIMEOUT_S,
        env=BANDS_ENV)
    assert restored == [composed[0][0]["validation_mIoU"]] * 2
    frames = np.random.default_rng(3).integers(0, 256, (2, *SIZE, 3),
                                               np.uint8)
    masks = Predictor.from_checkpoint(
        str(tmp_path / "composed" / "m"), image_size=SIZE, batch_size=2,
        dtype=torch.float32, device="cpu").predict(frames)
    assert masks.shape == (2, *SIZE) and masks.max() < 19


def test_cli_bands_need_as_many_cpu_devices(tmp_path):
    with pytest.raises(RuntimeError, match="RTSDS_CPU_DEVICES=2"):
        run_ranks(cli_worker, 2, (["--config", _config(
            tmp_path, "few", "mesh: {data: 2, spatial: 2}"), "--synthetic",
            "--dataset", "gta5"],), backend=None, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("gpus,spatial,local_rank,want", [
    (1, 2, 0, [0, 0]), (1, 2, 3, [0, 0]), (4, 2, 0, [0, 1]),
    (4, 2, 1, [2, 3]), (8, 4, 1, [4, 5, 6, 7]), (4, 2, 2, None),
    (3, 2, 1, None), (2, 3, 0, None)])
def test_band_devices_of_a_local_rank(monkeypatch, gpus, spatial,
                                      local_rank, want):
    from rtsds_tpu_torch.parallel.mesh import band_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    if want is None:
        with pytest.raises(ValueError, match="GPUs: launch at most"):
            band_devices("cuda", spatial, local_rank)
        return
    assert band_devices("cuda", spatial, local_rank) == [
        torch.device("cuda", i) for i in want]


def test_composed_job_mesh_holds_this_ranks_bands(monkeypatch):
    from rtsds_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(port_mesh, "process_count", lambda: 4)
    mesh = port_mesh.make_mesh_from_config({"data": 2, "spatial": 2,
                                            "model": 2})
    assert mesh.shape == {"data": 2, "spatial": 2, "model": 2}
    # local rank 1 (current device 2) bands over cuda:2 and cuda:3
    bands = [torch.device("cuda", 2), torch.device("cuda", 3)]
    assert mesh.axis_devices("spatial") == bands
    grid = mesh.grid
    for d in range(2):
        for m in range(2):
            assert list(grid[d, :, m]) == bands
    assert port_mesh.Mesh(["cpu"] * 2).axis_devices("spatial") == [
        torch.device("cpu")]


def test_a_training_layout_caches_no_weight_copy():
    """A sharded parameter is gathered anew each step and may reuse a freed
    pointer: the bands of a training batch carry no copy cache keyed by
    ``data_ptr`` that could hand out a stale copy (serving's
    ``SpatialModel`` keeps one, over weights that never move)."""
    from rtsds_tpu_torch.parallel.spatial import split_batch

    frames, labels = split_batch(torch.zeros(2, 8, 4, 3),
                                 torch.zeros(2, 8, 4, dtype=torch.long),
                                 ["cpu"] * 2)
    assert frames.layout is labels.layout
    assert labels.layout.copies == {}
