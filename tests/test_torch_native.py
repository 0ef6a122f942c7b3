"""The port's native audio runtime (``norma_tpu_torch/audio/native``, its
copy of the JAX package's C++ and ctypes binding): build, ring, packer,
resampler, mixdown.

The five cases of ``tests/test_native.py`` on the port.  The resampler and
the mixdown are held against the port's Python versions (within the JAX
test's tolerances) and against the JAX package's native versions on the
same inputs (exact: the same C++ source).  Skipped only where the JAX file
skips: when no C++ toolchain builds the library.
"""

import ctypes
import threading

import numpy as np
import pytest

from norma_tpu_torch.audio.native import load


@pytest.fixture(scope="module")
def lib():
    lib = load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_library_builds_into_the_port_build_dir(lib):
    from norma_tpu_torch.audio import native

    assert native.library_path().startswith(native.BUILD_DIR)
    assert lib._name == native.library_path()


def test_native_ring_roundtrip_and_drop(lib):
    from norma_tpu_torch.audio.native.wrappers import NativeRing

    ring = NativeRing(3, 100)
    for i in range(5):
        ring.try_send(np.full(100, float(i), np.float32), 100)
    # 3 slots -> 2 dropped
    assert ring.dropped == 2
    vals = []
    for _ in range(3):
        c = ring.recv(timeout=1.0)
        vals.append(float(c.data[0]))
        ring.release(c)
    assert vals == [0.0, 1.0, 2.0]
    ring.close()
    assert ring.recv(timeout=0.2) is None


def test_native_ring_cross_thread_final_chunk(lib):
    from norma_tpu_torch.audio.native.wrappers import NativeRing

    ring = NativeRing(8, 50)

    def producer():
        p = lib.nta_packer_new(ring.ptr)
        data = np.arange(120, dtype=np.float32)
        lib.nta_packer_append(p, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 120)
        lib.nta_packer_close(p)  # pops one -> final chunk of 19
        lib.nta_packer_free(p)
        ring.close()

    t = threading.Thread(target=producer)
    t.start()
    out = []
    while (c := ring.recv(timeout=2.0)) is not None:
        out.append((c.length, c.is_final))
        ring.release(c)
    t.join(timeout=10)
    assert not t.is_alive()
    assert out == [(50, False), (50, False), (19, True)]


def test_native_resampler_matches_python_and_jax(lib):
    from norma_tpu.audio.native import load as jax_load
    from norma_tpu_torch.audio.native.wrappers import NativeResampler
    from norma_tpu_torch.audio.resample import StreamingResampler

    rng = np.random.default_rng(0)
    x = rng.standard_normal(12_000).astype(np.float32)

    def run(r):
        return np.concatenate([r.process(x[i : i + 1000]) for i in range(0, len(x), 1000)])

    out_py = run(StreamingResampler(48_000, 16_000))
    out_nat = run(NativeResampler(48_000, 16_000))
    n = min(len(out_py), len(out_nat))
    assert n > 3500
    # f32 vs f64 accumulation: the JAX test's tolerance.
    np.testing.assert_allclose(out_py[:n], out_nat[:n], atol=2e-5)
    if jax_load() is not None:
        from norma_tpu.audio.native.wrappers import NativeResampler as JaxNativeResampler

        np.testing.assert_array_equal(out_nat, run(JaxNativeResampler(48_000, 16_000)))


def test_native_mixdown_formats(lib):
    from norma_tpu.audio.native import load as jax_load
    from norma_tpu_torch.audio.native.wrappers import native_mixdown
    from norma_tpu_torch.audio.pipeline import to_float

    rng = np.random.default_rng(1)
    for fmt, dtype in [("i16", np.int16), ("f32", np.float32), ("u8", np.uint8), ("i32", np.int32)]:
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            raw = rng.integers(info.min, info.max, size=400).astype(dtype)
        else:
            raw = rng.standard_normal(400).astype(dtype)
        got = native_mixdown(raw, 2, fmt)
        want = to_float(raw).reshape(-1, 2).mean(axis=1)
        np.testing.assert_allclose(got, want, atol=1e-6)
        if jax_load() is not None:
            from norma_tpu.audio.native.wrappers import native_mixdown as jax_mixdown

            np.testing.assert_array_equal(got, jax_mixdown(raw, 2, fmt))


def test_alsa_gracefully_unavailable_or_lists(lib):
    from norma_tpu_torch.audio.native import alsa

    devs = alsa.list_devices()
    assert isinstance(devs, list)  # [] on hosts without libasound
