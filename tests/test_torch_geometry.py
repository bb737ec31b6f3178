"""The PyTorch port's static state against the JAX package: Harvest
geometry, constants, the noise carrier, and the port's freedom from JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from worldtpu import constants as JC
from worldtpu.analysis import harvest as H
from worldtpu_torch import constants as TC
from worldtpu_torch import convert
from worldtpu_torch.analysis import harvest as TH

torch.set_num_threads(1)


@pytest.mark.parametrize("fs", [16000, 22050])
@pytest.mark.parametrize("f0_floor", [71.0, 40.0])
def test_geometry_fields_equal(fs, f0_floor):
    """Every field of the numpy re-derivation equals the JAX geometry's."""
    x_length = int(fs * 3.1)
    geo = H.HarvestGeometry(fs, x_length, f0_floor=f0_floor)
    mine = TH.HarvestGeometry(fs, x_length, f0_floor=f0_floor)
    fields = {k: v for k, v in vars(geo).items() if k != "_grid_cache"}
    assert set(fields) == set(vars(mine)) - {"_grid_cache"}
    assert geo._grid_cache == mine._grid_cache == {}
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(mine, k), v, err_msg=k)
        else:
            assert getattr(mine, k) == v, k
    # the converter rebuilds and checks the same geometry
    conv = convert.geometry_from_worldtpu(vars(geo))
    assert conv.e_max == geo.e_max and conv.refine_fft == geo.refine_fft


def test_geometry_converter_rejects_mismatch():
    geo = H.HarvestGeometry(16000, 8000)
    fields = dict(vars(geo), e_max=geo.e_max + 1)
    with pytest.raises(ValueError, match="e_max"):
        convert.geometry_from_worldtpu(fields)


def test_geometry_converter_rejects_cos_table_geometry():
    """A JAX geometry built with use_cos_table=True does not convert: the
    port has no table-lookup refine window, so it would compute another
    result."""
    geo = H.HarvestGeometry(22050, 22050, use_cos_table=True)
    with pytest.raises(ValueError, match="use_cos_table"):
        convert.geometry_from_worldtpu(vars(geo))


def test_constants_equal():
    names = [n for n in vars(JC) if n.isupper()]
    assert names
    for n in names:
        assert getattr(TC, n) == getattr(JC, n), n


def test_noise_from_numpy():
    arr = np.random.RandomState(0).randn(2, 5, 8)
    t = convert.noise_from_numpy(arr, "cpu")
    assert t.dtype == torch.float32 and t.shape == (2, 5, 8)
    np.testing.assert_array_equal(t.numpy(), arr.astype(np.float32))


def test_import_leaves_jax_out():
    """Importing the whole port in a fresh process loads no JAX."""
    code = (
        "import sys\n"
        "import worldtpu_torch\n"
        "from worldtpu_torch.parallel import batch\n"
        "from worldtpu_torch import convert, _build\n"
        "from worldtpu_torch.ops import zc_kernel, refine_kernel, "
        "ola_kernel\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'worldtpu' or m.startswith('worldtpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_sources():
    """No file of the port, not chip_smoke.py, not contour_profile.py and
    not the mesh tests' rank worker imports JAX or anything of
    ``worldtpu`` (the port keeps its own copies of what it needs)."""
    import pathlib
    import re
    root = pathlib.Path(TH.__file__).resolve().parents[1]
    banned = re.compile(r"^\s*(from|import)\s+(jax|worldtpu)(\.|\s|$)")
    worker = root.parent / "tests" / "torch_mesh_worker.py"
    paths = [*root.rglob("*.py"), root.parent / "chip_smoke.py",
             root.parent / "contour_profile.py", worker]
    assert len(paths) > 20
    assert {root / "codec.py", root / "io" / "corpus.py",
            root / "analysis" / "harvest.py", root / "native.py",
            root / "longaudio.py", root / "analysis" / "longform.py",
            root / "synthesis" / "noise.py", root / "api.py",
            root / "cli.py", root / "parallel" / "batch.py",
            root / "parallel" / "distributed.py",
            root / "parallel" / "__init__.py",
            root / "analysis" / "d4c.py"} <= set(paths)
    assert worker.is_file()
    for path in paths:
        for line in path.read_text().splitlines():
            assert not banned.match(line), (path, line)
