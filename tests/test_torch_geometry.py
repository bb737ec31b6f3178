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
    assert set(fields) == set(vars(mine))
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


#: the JAX package's numpy-only modules the port reads (file I/O and
#: metrics for the CLI, the host contour for long utterances); each is
#: imported inside the function that needs it
NUMPY_ONLY_IMPORTS = {
    "from worldtpu.io import params, wav",
    "from worldtpu.metrics import MetricsRecorder",
    "from worldtpu.analysis import contour",
}


def test_no_jax_import_in_sources():
    import pathlib
    root = pathlib.Path(TH.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import worldtpu." not in text, path
        for line in text.splitlines():
            line = line.strip()
            if line.startswith(("from worldtpu.", "from worldtpu import")):
                assert line in NUMPY_ONLY_IMPORTS, (path, line)
