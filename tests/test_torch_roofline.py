"""The port's roofline module: ``kernel_roofline`` on the card's and the
host's peaks with a device or a backend (its math, zero seconds, an
unknown backend), the peaks themselves, ``chip_smoke.py`` taking its
peaks from here, and the registry and this module importing with JAX and
the reference blocked."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import roofline as T  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernel_roofline_math():
    # 25.6 GB moved in 2 s = 12.8 GB/s achieved = half the cpu envelope
    out = T.kernel_roofline(25.6e9, 2.0, backend="cpu")
    assert out["backend"] == "cpu"
    assert out["achieved_gbps"] == pytest.approx(12.8)
    assert out["bandwidth_util"] == pytest.approx(0.5)
    # 3.35 GB in 2 ms on the card: half its HBM rate
    for where in ("gpu", "cuda", "cuda:0", torch.device("cuda", 1)):
        out = T.kernel_roofline(3.35e9, 2e-3, backend=where)
        assert out["backend"] == "gpu" and out["peak_gbps"] == 3350.0
        assert out["bandwidth_util"] == pytest.approx(0.5)
    assert T.kernel_roofline(1e9, 1.0, torch.device("cpu"))["backend"] == \
        "cpu"


def test_zero_seconds_is_zero_not_inf():
    out = T.kernel_roofline(1e9, 0.0, backend="gpu")
    assert out["achieved_gbps"] == 0.0 and out["bandwidth_util"] == 0.0


def test_unknown_backend_falls_back_to_cpu_envelope():
    out = T.kernel_roofline(1e9, 1.0, backend="quantum")
    assert out["backend"] == "quantum"
    assert out["peak_gbps"] == T.KERNEL_PEAKS["cpu"]["hbm_gbps"]


def test_default_backend_resolves_here():
    assert T.kernel_roofline(1e9, 1.0)["backend"] == "cpu"


def test_peaks_are_the_cards():
    assert set(T.KERNEL_PEAKS) == {"gpu", "cpu"}
    gpu = T.KERNEL_PEAKS["gpu"]
    assert gpu["peak_flops"] == T.PEAK_FLOPS == 989e12
    assert gpu["hbm_gbps"] == pytest.approx(T.HBM_BW / 1e9) == 3350.0
    assert T.FP32_FLOPS == 67e12
    assert "H100" in gpu["card"] and "700 W" in gpu["card"]
    assert T.LINK_BW == 450e9     # NVLink 4, each way
    for name, peaks in T.KERNEL_PEAKS.items():
        assert peaks["peak_flops"] > 0 and peaks["hbm_gbps"] > 0, name


def test_chip_smoke_takes_its_peaks_from_here():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.HBM_BYTES_PER_S == T.HBM_BW
    assert chip_smoke.FP32_OPS_PER_S == T.FP32_FLOPS
    assert chip_smoke.BF16_OPS_PER_S == T.PEAK_FLOPS


def test_tuning_and_roofline_import_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.kernels import tuning\n"
        "from repro_torch.launch import roofline\n"
        "assert tuning.get_kernel_config() == tuning.DEFAULTS\n"
        "with tuning.tuning_overrides(launch_pad_floor=4):\n"
        "    assert tuning.launch_pad(3) == 4\n"
        "assert tuning.launch_pad(3) == 4 and tuning.launch_pad(2) == 2\n"
        "assert roofline.kernel_roofline(3.35e9, 1e-3, 'cuda')"
        "['bandwidth_util'] == 1.0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
