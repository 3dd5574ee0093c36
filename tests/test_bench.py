"""bench.py's device facts: the peak table is keyed by device_kind, an
unknown device or a peak given in the environment is an error, and the
GEMM-share denominator matches the assembly GEMMs' precision."""

import os
import sys
from types import SimpleNamespace

import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402

H100 = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")


def test_known_device_has_data_sheet_peaks(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_FLOPS", raising=False)
    peaks = bench.device_peaks(H100)
    assert peaks["tf32_flops"] == 495e12
    assert peaks["f32_flops"] == 67e12
    assert peaks["hbm_bytes"] == 3.35e12


def test_unknown_device_is_an_error(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_FLOPS", raising=False)
    with pytest.raises(SystemExit, match="no peak rates"):
        bench.device_peaks(jax.devices()[0])  # the CPU


def test_peak_from_environment_is_an_error(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "4.92e13")
    with pytest.raises(SystemExit, match="not read"):
        bench.device_peaks(H100)


def test_gemm_peak_matches_assembly_precision():
    peaks = bench.PEAKS[H100.device_kind]
    f32 = SimpleNamespace(dtype=jnp.float32)
    assert bench.gemm_peak_flops(f32, peaks) == peaks["tf32_flops"]
    with pytest.raises(ValueError):
        bench.gemm_peak_flops(SimpleNamespace(dtype=jnp.float64), peaks)
