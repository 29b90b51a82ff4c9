"""The port's offline GTA5 converter and dataset checker against the JAX
package's (``rtsds_tpu/data/convert_gta5.py``, ``rtsds_tpu/data/check.py``)
on the same small trees: the converted PNGs and stats are equal
(exactly), and the checker's findings are equal, the tool's module name
aside.  On the CPU the converter remaps with the plain version of K2."""

import os

import numpy as np
import pytest
import yaml
from PIL import Image

from realdata_fixtures import make_cityscapes_tree, make_gta5_tree
from rtsds_tpu.data import check as jax_check
from rtsds_tpu.data import convert_gta5 as jax_convert
from rtsds_tpu_torch.data import check, convert_gta5
from rtsds_tpu_torch.utils.colors import class_colors_for_remap


def test_lut_and_convert_labels_match_jax():
    """The port's LUT is JAX's; on GTA5's table (no equal keys) the
    first-match remap equals it on every class colour and on colours
    that are no key."""
    lut = convert_gta5.build_lut()
    np.testing.assert_array_equal(lut, jax_convert.build_lut())
    table = np.asarray(class_colors_for_remap(), np.uint8)
    rng = np.random.default_rng(0)
    rgb = table[rng.integers(0, len(table), (3, 17, 23))]
    rgb[:, ::4] = rng.integers(0, 256, (3, 5, 23, 3))
    packed = ((rgb[..., 0].astype(np.uint32) << 16)
              | (rgb[..., 1].astype(np.uint32) << 8) | rgb[..., 2])
    got = convert_gta5.convert_labels(rgb, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (3, 17, 23)
    np.testing.assert_array_equal(got, lut[packed])
    assert (got == 255).any() and (got < 19).any()


def test_convert_tree_writes_jaxs_pngs_and_stats(tmp_path):
    make_gta5_tree(str(tmp_path / "raw"), n=4, rgb_coded=True, seed=7)
    want = jax_convert.convert_tree(str(tmp_path / "raw"),
                                    str(tmp_path / "jax"), workers=2,
                                    quiet=True)
    got = convert_gta5.convert_tree(str(tmp_path / "raw"),
                                    str(tmp_path / "port"), workers=2,
                                    quiet=True, device="cpu")
    assert got == want and got["converted"] == 4 and got["linked"] == 4
    names = sorted(os.listdir(tmp_path / "jax" / "labels"))
    assert names == sorted(os.listdir(tmp_path / "port" / "labels"))
    for sub in ("labels", "images"):
        for name in names:
            a = Image.open(tmp_path / "jax" / sub / name)
            b = Image.open(tmp_path / "port" / sub / name)
            assert a.mode == b.mode
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # labels already converted are skipped, unless overwrite
    again = convert_gta5.convert_tree(str(tmp_path / "raw"),
                                      str(tmp_path / "port"), workers=2,
                                      quiet=True, device="cpu")
    assert (again["converted"], again["skipped"]) == (0, 4)
    redo = convert_gta5.convert_tree(str(tmp_path / "raw"),
                                     str(tmp_path / "port"), workers=2,
                                     overwrite=True, quiet=True, device="cpu")
    assert (redo["converted"], redo["skipped"]) == (4, 0)


def test_convert_cli(tmp_path, capsys):
    make_gta5_tree(str(tmp_path / "raw"), n=2, rgb_coded=True, seed=3)
    assert convert_gta5.main(["--src", str(tmp_path / "raw"), "--dst",
                              str(tmp_path / "mod"), "--no_images",
                              "--device", "cpu"]) == 0
    assert "2 labels converted" in capsys.readouterr().out
    assert not (tmp_path / "mod" / "images").exists()
    assert convert_gta5.main(["--src", str(tmp_path / "none"), "--dst",
                              str(tmp_path / "x"), "--device", "cpu"]) == 2
    assert "no labels/ directory" in capsys.readouterr().err


def _same_findings(port, jax):
    def text(findings):
        return [(f["level"], f["message"].replace("rtsds_tpu.",
                                                  "rtsds_tpu_torch."))
                for f in findings]
    assert text(port) == text(jax)


@pytest.mark.parametrize("rgb_coded,decode", [(True, False), (True, True),
                                              (False, True), (False, False)])
def test_gta5_findings_are_jaxs(tmp_path, rgb_coded, decode):
    cfg = make_gta5_tree(str(tmp_path), rgb_coded=rgb_coded)
    cfg.update(num_classes=19, decode_label_colors=decode)
    findings = check.check_gta5(cfg)
    _same_findings(findings, jax_check.check_gta5(cfg))
    assert any(f["level"] == "ERROR" for f in findings) == (
        rgb_coded and not decode)


def test_cityscapes_findings_are_jaxs(tmp_path):
    cfg = dict(make_cityscapes_tree(str(tmp_path)), num_classes=19)
    for split in ("train", "val"):
        _same_findings(check.check_cityscapes(cfg, split),
                       jax_check.check_cityscapes(cfg, split))
    # an image without its trainId label, and labels of raw ids
    img_dir = cfg["images_train_dir"]
    city = sorted(os.listdir(img_dir))[0]
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        os.path.join(img_dir, city, "zz_000000_000000_leftImg8bit.png"))
    lbl_dir = os.path.join(cfg["segmentation_train_dir"], city)
    for name in [n for n in sorted(os.listdir(lbl_dir))
                 if not n.endswith("color.png")][:2]:
        path = os.path.join(lbl_dir, name)
        lbl = np.asarray(Image.open(path)).copy()
        lbl[0, :4] = [25, 30, 33, 7]
        Image.fromarray(lbl).save(path)
    findings = check.check_cityscapes(cfg, "train", sample_count=8)
    _same_findings(findings, jax_check.check_cityscapes(cfg, "train",
                                                        sample_count=8))
    levels = {f["level"] for f in findings}
    assert "WARN" in levels
    cfg["images_val_dir"] = str(tmp_path / "nope")
    _same_findings(check.check_cityscapes(cfg, "val"),
                   jax_check.check_cityscapes(cfg, "val"))


def test_check_cli_exit_codes(tmp_path, capsys):
    cs = make_cityscapes_tree(str(tmp_path / "cs"))
    gta = make_gta5_tree(str(tmp_path / "gta"))
    cfg = {"data": {"cityscapes": {**cs, "num_classes": 19},
                    "gta5_modified": {**gta, "num_classes": 19}}}
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump(cfg))
    assert check.main(["--config", str(p)]) == 0
    port_out = capsys.readouterr().out
    assert jax_check.main(["--config", str(p)]) == 0
    assert port_out == capsys.readouterr().out
    assert "0 error(s)" in port_out
    cfg["data"]["gta5_modified"]["images_dir"] = str(tmp_path / "missing")
    p.write_text(yaml.safe_dump(cfg))
    assert check.main(["--config", str(p), "--dataset", "gta5"]) == 1
    out = capsys.readouterr().out
    assert "images_dir" in out and "1 error(s)" in out
