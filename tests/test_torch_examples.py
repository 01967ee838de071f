"""The examples on the port (strolle_tpu_torch/examples/), each run
in-process through its ``main`` on the CPU at a tiny size: its images
written and finite. No JAX."""

import os

import numpy as np
import pytest
import torch_port_arrays  # noqa: F401  (one torch thread per test process)
from PIL import Image

from strolle_tpu_torch.examples import (cornell, demo, fit_materials, minecraft, stress_bvh,
                                        stress_large, stress_lights, viewer)
from strolle_tpu_torch.ops import trace

SMALL = ["--cpu", "--width", "16", "--height", "12", "--frames", "2"]

CASES = {
    "cornell": (cornell.main, SMALL),
    "cornell_reference": (cornell.main, SMALL + ["--mode", "reference"]),
    "demo": (demo.main, SMALL),
    "minecraft": (minecraft.main, SMALL),
    "stress_bvh": (stress_bvh.main, SMALL),
    "stress_lights": (stress_lights.main, SMALL),
    # over 1024 triangles, with a BVH: kernels 5 and 6 ("stream")
    "stress_large": (stress_large.main, ["--cpu", "--tris", "4096", "--width", "16",
                                         "--height", "16", "--frames", "1"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_writes_finite_images(name, tmp_path):
    main, argv = CASES[name]
    out = main(argv + ["--out", str(tmp_path)])
    assert out["pngs"] and out["finite"], out
    for path in out["pngs"]:
        assert os.path.dirname(path) == str(tmp_path)
        with Image.open(path) as im:
            assert im.size[0] == 16 and im.mode == "RGB"
    if name == "stress_large":
        assert out["stream"] and out["triangles"] == 4096 and out["clusters"] == 16
        assert trace.is_big(out["scene"])


def test_fit_materials_walks_toward_the_truth(tmp_path):
    """Five Adam steps at 16x16: the red wall's colour error (max over
    RGB) falls by more than 0.1 from its perturbed start and the green
    wall's falls, the same way under the fixed seeds on every run."""
    out = fit_materials.main(["--cpu", "--size", "16", "--steps", "5", "--out", str(tmp_path)])
    assert [os.path.basename(p) for p in out["pngs"]] == ["target.png", "fitted.png"]
    assert out["finite"] and all(np.isfinite(out["losses"]))
    assert out["err_red"][-1] < out["err_red"][0] - 0.1, out["err_red"]
    assert out["err_green"][-1] < out["err_green"][0], out["err_green"]


def test_viewer_headless(tmp_path):
    """Two frames with the HTTP server on a free port, one GET of the
    frame, the server stopped."""
    out = viewer.main(["--cpu", "--width", "16", "--height", "12", "--frames", "2",
                       "--port", "0", "--out", str(tmp_path)])
    assert out["port"] > 0 and out["frames"] == 2
    with Image.open(out["jpg"]) as im:
        assert im.size == (16, 12)
        assert np.asarray(im).mean() > 0
