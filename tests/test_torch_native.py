"""The port's native host library (winograd_tpu_torch/native/winotpu.cpp via
utils/native.py) on the CPU: built by g++ under build/ at the repository
root, it reads, writes and transposes blobs and checks outputs exactly as
numpy does and as the JAX package's native library (winograd_tpu/utils/
native.py) does on the same blobs: the same values to the bit, the same
violation count and max error at shift 0 and 1, NaN counted. Every call it
serves is counted in native.CALLS; without the library the numpy path
serves and counts nothing. The library needs g++; without it these tests
skip."""

import pathlib

import numpy as np
import pytest

from winograd_tpu.utils import checker as jax_checker
from winograd_tpu.utils import io as jax_io
from winograd_tpu.utils import native as jax_native
from winograd_tpu_torch.utils import checker, io, native, timing

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def library():
    if not native.available():
        pytest.skip("g++ could not build the native host library")
    native.CALLS.clear()


def test_library_builds_under_the_repository_build_directory():
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "winograd_tpu_torch"
    assert path.name.startswith("libwinotpu-") and path.suffix == ".so"


def _blobs(tmp_path, sizes=(1, 7, 4096, 100_003)):
    rng = np.random.default_rng(0)
    spec, data = {}, {}
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"blob{i}.bin")
        data[p] = rng.standard_normal(n).astype(np.float32)
        data[p].tofile(p)
        spec[p] = n
    return spec, data


def test_reads_equal_numpy_and_the_jax_library(tmp_path):
    spec, data = _blobs(tmp_path)
    many = io.get_parameters(spec)
    numpy_many = io.get_parameters_numpy(spec)
    jax_many = jax_io.get_parameters(spec)
    for p, n in spec.items():
        one = io.get_parameter(p, n)
        for got in (one, many[p], numpy_many[p], jax_many[p], jax_io.get_parameter(p, n)):
            np.testing.assert_array_equal(got, data[p])
    assert native.CALLS == {"wt_read_many_f32": 1, "wt_read_f32": len(spec)}


def test_write_round_trips_and_short_or_missing_files_raise(tmp_path):
    data = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    io.save_parameter(tmp_path / "w.bin", data)
    assert native.CALLS["wt_write_f32"] == 1
    np.testing.assert_array_equal(np.fromfile(tmp_path / "w.bin", "<f4"), data)
    np.testing.assert_array_equal(jax_io.get_parameter(tmp_path / "w.bin", 1000), data)
    with pytest.raises(ValueError, match="expected 1001"):
        io.get_parameter(tmp_path / "w.bin", 1001)
    with pytest.raises(FileNotFoundError):
        io.get_parameter(tmp_path / "nope.bin", 10)
    with pytest.raises(FileNotFoundError):
        io.get_parameters({str(tmp_path / "nope.bin"): 10, str(tmp_path / "w.bin"): 1000})


@pytest.mark.parametrize("h,w", [(1, 1), (3, 4), (37, 129)])
def test_transpose_equals_numpy_and_the_jax_library(h, w):
    a = np.random.default_rng(h).standard_normal(h * w).astype(np.float32)
    out = io.transpose(a, h, w)
    np.testing.assert_array_equal(out, io.transpose_numpy(a, h, w))
    np.testing.assert_array_equal(out, jax_io.transpose(a, h, w))
    np.testing.assert_array_equal(out, a.reshape(h, w).T.ravel())
    assert native.CALLS["wt_transpose_f32"] == 1


@pytest.mark.parametrize("shift", [0, 1])
def test_checker_count_and_max_error_equal_numpy_and_the_jax_library(shift):
    rng = np.random.default_rng(shift)
    length, channels = 14, 8
    b = rng.standard_normal((length, length, channels)).astype(np.float32)
    a = np.zeros((length + 2 * shift,) * 2 + (channels,), np.float32)
    a[shift:shift + length, shift:shift + length] = b
    a[shift + 3, shift + 5, 2] += 0.5
    a[shift + 9, shift, 7] -= 2e-4
    a[shift + 1, shift + 1, 1] += 5e-5    # within the bar
    ours = checker.output_checker(a, b, length, channels, shift, tol=1e-4)
    assert native.CALLS["wt_output_checker"] == 1
    for ref in (checker.output_checker_numpy(a, b, length, channels, shift, tol=1e-4),
                jax_checker.output_checker(a, b, length=length, channels=channels,
                                           shift=shift, tol=1e-4)):
        assert (ours.error_count, ours.total) == (ref.error_count, ref.total) == (2, b.size)
        assert ours.max_error == pytest.approx(ref.max_error, rel=1e-6)
    a[shift + 2, shift + 2, 0] = np.nan
    ours = checker.output_checker(a, b, length, channels, shift, tol=1e-4)
    ref = jax_checker.output_checker(a, b, length=length, channels=channels, shift=shift,
                                     tol=1e-4)
    assert ours.error_count == ref.error_count == 3
    assert np.isnan(ours.max_error) and np.isnan(ref.max_error) and not ours.ok()


def test_the_jax_library_builds_as_the_reference():
    assert jax_native.available()


def test_clock_and_the_numpy_path_without_the_library(monkeypatch, tmp_path):
    t = timing.get_time_microseconds64()
    assert abs(t - jax_native.load().wt_time_us()) < 10_000_000
    assert native.CALLS["wt_time_us"] == 1
    native.CALLS.clear()
    monkeypatch.setattr(native, "load", lambda: None)
    spec, data = _blobs(tmp_path, sizes=(5, 9))
    for p, a in io.get_parameters(spec).items():
        np.testing.assert_array_equal(a, data[p])
    io.save_parameter(tmp_path / "x.bin", data[next(iter(data))])
    np.testing.assert_array_equal(io.transpose(np.arange(6, dtype=np.float32), 2, 3),
                                  [0, 3, 1, 4, 2, 5])
    b = np.ones((2, 2, 3), np.float32)
    assert checker.output_checker(np.pad(b, ((1, 1), (1, 1), (0, 0))), b, 2, 3, 1).ok()
    assert timing.get_time_microseconds64() > 0
    assert native.CALLS == {}
