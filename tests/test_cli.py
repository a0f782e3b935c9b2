"""CLI tests (the headless equivalent of the reference's interactive app, C1)."""
import os

import numpy as np
import pytest

from cg_raytracer.cli import main


def test_list_scenes(capsys):
    assert main(["list-scenes"]) == 0
    out = capsys.readouterr().out
    assert "cornell_box" in out and "dragon" in out


def test_render_writes_png(tmp_path, capsys):
    out = str(tmp_path / "r.png")
    rc = main(["render", "--scene", "cube", "--width", "32", "--height", "32",
               "-o", out])
    assert rc == 0
    assert os.path.exists(out)
    txt = capsys.readouterr().out
    assert "Time to render image" in txt  # main.cpp:796 parity printout
    from cg_raytracer.utils.image import read_image

    img = read_image(out)
    assert img.shape == (32, 32, 3) and img.max() > 0


def test_render_bmp_and_light_override(tmp_path):
    out = str(tmp_path / "r.bmp")
    rc = main(["render", "--scene", "cube", "--width", "24", "--height", "24",
               "--light-pos", "0", "3", "-3", "--light-color", "2", "0", "0",
               "-o", out])
    assert rc == 0 and os.path.exists(out)
    from cg_raytracer.utils.image import read_image

    img = read_image(out)
    # Red-tinted light: red channel dominates everywhere it's lit.
    lit = img.max(axis=-1) > 0.05
    assert lit.any()
    assert (img[..., 0][lit] >= img[..., 1][lit] - 1e-6).all()


def test_optimize_cli(tmp_path, capsys):
    # Render a tiny target, then run a few optimization steps against it.
    target = str(tmp_path / "t.png")
    main(["render", "--scene", "cube", "--width", "24", "--height", "24",
          "-o", target])
    rc = main(["optimize", "--scene", "cube", "--width", "24", "--height", "24",
               "--target", target, "--steps", "3", "--lr", "0.01"])
    assert rc == 0
    assert "final loss" in capsys.readouterr().out


def test_optimize_size_mismatch(tmp_path, capsys):
    target = str(tmp_path / "t.png")
    main(["render", "--scene", "cube", "--width", "16", "--height", "16",
          "-o", target])
    rc = main(["optimize", "--scene", "cube", "--width", "24", "--height", "24",
               "--target", target, "--steps", "1"])
    assert rc == 2


def test_light_editor_add_remove(tmp_path):
    # Full editor session (main.cpp:812-876 capabilities): remove the preset's
    # point lights, add a spherical one, and edit it by unified index.
    out = str(tmp_path / "r.png")
    rc = main(["render", "--scene", "cornell_box", "--width", "24", "--height",
               "24", "--spp", "4",
               "--remove-light", "0",
               "--add-spherical-light", "0", "0.4", "0", "0.1", "4", "4", "4",
               "--light-index", "0", "--light-radius", "0.2",
               "-o", out])
    assert rc == 0 and os.path.exists(out)
    from cg_raytracer.utils.image import read_image

    img = read_image(out)
    assert img.max() > 0  # the new spherical light illuminates the box


def test_light_editor_radius_on_point_light_errors():
    with pytest.raises(ValueError, match="point light"):
        main(["render", "--scene", "cube", "--width", "8", "--height", "8",
              "--light-radius", "0.3"])


def test_unknown_scene_errors():
    with pytest.raises(SystemExit):
        main(["render", "--scene"])  # missing value
    with pytest.raises(ValueError):
        main(["render", "--scene", "not_a_scene", "--width", "8", "--height", "8"])
